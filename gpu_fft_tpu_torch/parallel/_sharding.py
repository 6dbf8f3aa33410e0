"""What the parallel layer shares: mesh axes, DTensor placements and the
tiled all-to-all.

The JAX package writes ``shard_map`` bodies over a ``jax.sharding.Mesh``
with ``PartitionSpec``s; here a :class:`~torch.distributed.device_mesh.DeviceMesh`
with named dimensions takes the mesh's place, a spec becomes one DTensor
placement per mesh dimension (``Shard(d)`` where the spec names that axis,
``Replicate()`` elsewhere) and a body runs on ``.to_local()`` shards.  A
plain tensor or numpy array is the global array that every rank holds (as
``jnp.asarray`` takes it); each rank keeps its own slice, with no
collective.  Collectives run on the process group of a mesh axis, and a
CUDA mesh takes only CUDA tensors: nothing goes through a CPU group.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard


def axis_size(mesh, axis: str) -> int:
    """The size of the mesh dimension named ``axis`` (JAX: ``mesh.shape[axis]``)."""
    return mesh.size(_dim(mesh, axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (JAX: ``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def group(mesh, axis: str):
    """The process group of ``axis``; refuses a CUDA mesh whose group is not
    NCCL's, so that no CUDA tensor goes through gloo."""
    g = mesh.get_group(axis)
    if mesh.device_type == "cuda" and dist.get_backend(g) != "nccl":
        raise ValueError(f"mesh axis {axis!r} is a CUDA mesh on a {dist.get_backend(g)!r} group; "
                         "CUDA tensors need NCCL")
    return g


def _dim(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are {names}")
    return names.index(axis)


def device(mesh) -> torch.device:
    """The device of this rank's shards."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def placements(mesh, dims: dict) -> list:
    """One placement per mesh dimension: ``Shard(dims[name])`` for the mesh
    axes named in ``dims`` (a None name is skipped), ``Replicate()`` for the
    rest (JAX: a ``PartitionSpec``)."""
    dims = {k: v for k, v in dims.items() if k is not None}
    for name in dims:
        _dim(mesh, name)
    return [Shard(dims[name]) if name in dims else Replicate() for name in mesh.mesh_dim_names]


def global_tensor(x, mesh) -> torch.Tensor | DTensor:
    """``x`` as the float32 global array: a DTensor as it is, a tensor or
    array moved to the mesh's device.  A CUDA tensor on a CPU mesh raises."""
    if isinstance(x, DTensor):
        if x.device_mesh != mesh:
            raise ValueError("a DTensor on another mesh")
        return x if x.dtype == torch.float32 else x.to(torch.float32)
    if isinstance(x, torch.Tensor):
        if x.device.type != mesh.device_type and x.device.type != "cpu":
            raise ValueError(f"a tensor on {x.device} given to a {mesh.device_type} mesh")
        return x.to(device=device(mesh), dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device(mesh))


def to_local(x, mesh, places: list) -> torch.Tensor:
    """This rank's shard of the global ``x`` under ``places``: a DTensor is
    redistributed where its placements differ; a plain global tensor is
    sliced, contiguous, with no collective."""
    if isinstance(x, DTensor):
        if list(x.placements) != list(places):
            x = x.redistribute(mesh, places)
        return x.to_local().contiguous()
    for name, p in zip(mesh.mesh_dim_names, places):
        if isinstance(p, Shard):
            size, rank = axis_size(mesh, name), axis_rank(mesh, name)
            step = x.shape[p.dim] // size
            x = x.narrow(p.dim, rank * step, step)
    return x.contiguous()


def from_local(local: torch.Tensor, mesh, places: list, shape) -> DTensor:
    """The DTensor of global ``shape`` whose shard on this rank is ``local``."""
    shape = tuple(shape)
    stride = tuple(int(s) for s in torch.empty(shape, device="meta").stride())
    return DTensor.from_local(local, mesh, places, run_check=False, shape=torch.Size(shape), stride=stride)


def all_to_all(x: torch.Tensor, mesh, axis: str, split_axis: int, concat_axis: int) -> torch.Tensor:
    """JAX's ``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``x`` cut in ``d`` pieces along ``split_axis``, piece j sent to rank j
    of ``axis``, the pieces received put side by side along ``concat_axis``
    in rank order; one ``all_to_all_single`` on a contiguous copy with the
    split axis in front."""
    d = axis_size(mesh, axis)
    moved = x.movedim(split_axis, 0)
    send = moved.reshape(d, moved.shape[0] // d, *moved.shape[1:]).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group(mesh, axis))
    # recv[j] is rank j's piece; put the split axis back, then rank j's
    # index beside the concat axis, and merge the two.
    recv = recv.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(x.shape)
    shape[split_axis] //= d
    shape[concat_axis] *= d
    return recv.reshape(shape)
