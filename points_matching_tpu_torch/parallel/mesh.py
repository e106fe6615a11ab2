"""Process groups as a named mesh — port of
``points_matching_tpu/parallel/mesh.py``.

The reference names the axes of a ``jax.sharding.Mesh``; here each axis is
a ``torch.distributed`` process group, taken from a ``DeviceMesh``
(``init_device_mesh``) by name:

  * ``data``  — frames, segments, image pairs (BASELINE configs 1 and 4),
  * ``model`` — landmarks / observations inside one problem (the Schur
                reduction of the global BA),
  * ``stage`` — pipeline stages (``parallel/pipeline.py``).

Backends: NCCL wherever the tensors are on CUDA; gloo when asked, for CPU
tensors and for several processes sharing one GPU (NCCL refuses two ranks
on one device).  Every group is made with a timeout, so a rendezvous or a
collective that a rank never joins fails after it instead of hanging.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from points_matching_tpu_torch.parallel.comm import Comm

Tensor = torch.Tensor

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"
DEFAULT_TIMEOUT_S = 60.0


def _timedelta(timeout: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(timeout))


def initialize_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout: float = DEFAULT_TIMEOUT_S,
    device: str = "cuda",
    force: bool = False,
) -> bool:
    """Join the default process group (``init_process_group``).

    ``world_size``, ``rank`` and the rendezvous default to ``WORLD_SIZE``,
    ``RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` as ``torchrun`` sets them.
    At world size 1 this is a no-op unless ``force`` (one rank over NCCL,
    say); returns whether a group was made.  ``backend`` defaults to NCCL
    for ``device="cuda"`` and gloo for ``device="cpu"``.  ``timeout``
    (seconds) bounds the rendezvous and every collective of the group.
    """
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size <= 1 and not force:
        return False
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if init_method is None:
        init_method = (f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:"
                       f"{os.environ['MASTER_PORT']}")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=_timedelta(timeout))
    return True


def _backend_options(backend: str, timeout: float):
    """Options that give a new group ``timeout`` (a DeviceMesh's groups
    would otherwise take the backend's default of many minutes)."""
    opts = (dist.ProcessGroupNCCL.Options() if backend == "nccl"
            else dist.ProcessGroupGloo._Options())
    opts._timeout = _timedelta(timeout)
    return (backend, opts)


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axes: Sequence[str] = (DATA_AXIS,),
              device_type: Optional[str] = None,
              timeout: float = DEFAULT_TIMEOUT_S):
    """A ``DeviceMesh`` over the default group's ranks with named axes.

    ``shape`` defaults to every rank on the first axis and 1 on the rest.
    ``device_type`` defaults to ``"cuda"`` for an NCCL default group and
    ``"cpu"`` for gloo.  Each axis's group gets ``timeout`` seconds."""
    from torch.distributed.device_mesh import init_device_mesh

    axes = tuple(axes)
    if shape is None:
        shape = (dist.get_world_size(),) + (1,) * (len(axes) - 1)
    backend = dist.get_backend()
    if device_type is None:
        device_type = "cuda" if backend == "nccl" else "cpu"
    opts = _backend_options(backend, timeout)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes,
                            backend_override={a: opts for a in axes})


def axis_size(mesh, axis: str) -> int:
    """The number of ranks on ``axis`` (1 without a mesh or such an axis)."""
    if not has_axis(mesh, axis):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def has_axis(mesh, axis: str) -> bool:
    return mesh is not None and axis in (mesh.mesh_dim_names or ())


def axis_comm(mesh, axis: str) -> Comm:
    """``Comm`` over ``axis`` of ``mesh`` (its group even at one rank, so a
    one-rank run still goes through the backend); the no-op backend without
    a mesh or without such an axis."""
    return Comm(mesh.get_group(axis)) if has_axis(mesh, axis) else Comm(None)


def shard(x: Tensor, mesh, axis: str = DATA_AXIS) -> Tensor:
    """This rank's block of the leading axis of ``x``, split evenly over
    ``axis`` (the block a ``P(axis)`` sharding puts on a device)."""
    comm = axis_comm(mesh, axis)
    n = comm.size()
    if x.shape[0] % n:
        raise ValueError(f"leading axis ({x.shape[0]}) must divide the {axis} axis ({n}); "
                         "pad with masked rows")
    b = x.shape[0] // n
    return x[comm.index() * b:(comm.index() + 1) * b]


def replicated(x: Tensor, mesh) -> Tensor:
    """``x`` as the mesh's first rank holds it, on every rank (a broadcast
    over all the mesh's ranks)."""
    if mesh is None or mesh.size() == 1:
        return x
    return Comm(dist.group.WORLD).broadcast(x, src=0)


def host_local_to_global(mesh, axis: str, local: Tensor) -> Tensor:
    """The global array from each rank's host-local block of the leading
    axis: an ``all_gather`` over ``axis``, blocks in rank order."""
    return axis_comm(mesh, axis).all_gather(local, tiled=True)
