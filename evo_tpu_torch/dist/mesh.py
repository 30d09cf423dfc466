"""The (space, batch) device mesh — counterpart of `evo_tpu/dist/mesh.py`.

Two logical axes, as in the JAX package:

- ``"space"``: spatial tiles of the sensor plane (the 12x9 contrast-max tile
  grid's columns);
- ``"batch"``: event sub-streams, patch rows and temporal windows.

`make_mesh` lays the ranks of the initialised process group out row-major,
as JAX's `devices.reshape(n_space, n_batch)`, in a
`torch.distributed.device_mesh.DeviceMesh`; the collectives of this package
run on its per-axis process groups (`mesh.get_group(axis)`). The tracker's
collectives run on `table_group`, over all axes in block order, and the
evaluator's compensation on `fork_mesh`, so that the pipelined drive's two
threads never issue collectives on one communicator.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

SPACE_AXIS = "space"
BATCH_AXIS = "batch"
AXES = (SPACE_AXIS, BATCH_AXIS)


def make_mesh(n_space: int | None = None, n_batch: int | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """A (space, batch) mesh over every rank of the default process group.

    Defaults: all ranks on the batch axis; pass `n_space` to carve spatial
    tiling out of them. `device_type` None: "cuda" under NCCL, else "cpu".
    Raises when no process group is initialised
    (`dist.multihost.initialize`) or the shape does not cover the world."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call evo_tpu_torch.dist.multihost."
                           "initialize (or torch.distributed.init_process_group) first")
    n = dist.get_world_size()
    if n_space is None and n_batch is None:
        n_space, n_batch = 1, n
    elif n_space is None:
        n_space = n // n_batch
    elif n_batch is None:
        n_batch = n // n_space
    if n_space * n_batch != n:
        raise ValueError(f"{n_space}x{n_batch} mesh cannot cover {n} devices")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_space, n_batch), mesh_dim_names=AXES)


def mesh_on_new_groups(ranks, device_type: str, names=AXES) -> DeviceMesh | None:
    """A mesh of the layout `ranks` (a 2-D tensor of global ranks) on process
    groups created anew, one per row of each axis; None on a rank outside
    `ranks`. Every rank of the world must call this, in the same order as
    its other group creations (each creates every group)."""
    me = dist.get_rank()
    groups = []
    for dim in range(ranks.ndim):
        mine = None
        for row in ranks.movedim(dim, -1).reshape(-1, ranks.shape[dim]).tolist():
            g = dist.new_group(row)
            if me in row:
                mine = g
        groups.append(mine)
    if me not in ranks.reshape(-1).tolist():
        return None
    return DeviceMesh.from_group(groups, device_type, mesh=ranks, mesh_dim_names=names)


def fork_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The same (space, batch) layout on process groups of its own.

    NCCL and gloo pair the collectives of a communicator by their order, so
    two threads that issue collectives concurrently need one communicator
    each: a different axis is not enough, since `init_device_mesh` may give
    an axis that spans the world the default group. Every rank must call
    this, in the same order as its other group creations."""
    return mesh_on_new_groups(mesh.mesh, mesh.device_type, mesh.mesh_dim_names)


def table_group(mesh: DeviceMesh):
    """A process group of its own over every rank of the mesh, its group
    ranks in block order (lin = space_index · n_batch + batch_index, the
    patch table's row blocks, as JAX's `P((SPACE, BATCH))` orders them).
    Every rank must call this, like `fork_mesh`."""
    ranks = mesh.mesh.reshape(-1).tolist()
    if ranks != sorted(ranks):
        raise ValueError(f"the mesh's ranks {ranks} are not in block order")
    return dist.new_group(ranks)


def block_index(mesh: DeviceMesh) -> int:
    """This rank's block of rows split over all axes (lin above)."""
    return axis_index(mesh, SPACE_AXIS) * axis_size(mesh, BATCH_AXIS) \
        + axis_index(mesh, BATCH_AXIS)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return mesh.get_local_rank(axis)


def block(mesh: DeviceMesh, axis: str, n: int) -> slice:
    """This rank's contiguous block of `n` rows split evenly over `axis`;
    raises unless the axis size divides `n`."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{n} rows do not split over the {size} ranks of {axis!r}")
    k = axis_index(mesh, axis)
    return slice(k * n // size, (k + 1) * n // size)


def _placements(mesh: DeviceMesh, shard: dict):
    """One DTensor placement per mesh dimension: `Shard(shard[name])` on the
    dimensions `shard` names, `Replicate()` on the others."""
    return tuple(Shard(shard[name]) if name in shard else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh):
    """Every rank holds the whole tensor."""
    return _placements(mesh, {})


def batch_sharded(mesh: DeviceMesh, axis: int = 0):
    """Tensor dimension `axis` split over ``batch`` (each rank's part is its
    `block(mesh, BATCH_AXIS, n)`), replicated over ``space``."""
    return _placements(mesh, {BATCH_AXIS: axis})


def space_sharded(mesh: DeviceMesh, axis: int = 0):
    """Tensor dimension `axis` split over ``space``, replicated over
    ``batch``."""
    return _placements(mesh, {SPACE_AXIS: axis})


def all_gather_cat(t, group, dim: int = 0):
    """The blocks `t` of every rank of `group` concatenated along `dim`, in
    the group's rank order (every rank's block has one shape)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(group.size())]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def gather_rows(tree: dict, group, dims: dict | int = 0) -> dict:
    """Every rank's blocks of the tensors of `tree` concatenated along their
    row axis (`dims`: one for all, or {name: axis}), in one `all_gather`
    over `group`: the JAX package's out_specs of a row-sharded `shard_map`
    output. The tensors travel bit for bit as int32 columns, bool as int32
    0/1 (gloo reduces no bool), so they must be bool or of a 4-byte dtype.
    `group` None (no mesh): the blocks are the whole rows, returned as they
    are."""
    if group is None:
        return dict(tree)
    cols, metas = [], []
    for name, t in tree.items():
        d = dims if isinstance(dims, int) else dims[name]
        rows = t.movedim(d, 0)
        if t.dtype == torch.bool:
            flat = rows.reshape(rows.shape[0], -1).to(torch.int32)
        elif t.element_size() == 4:
            flat = rows.contiguous().view(torch.int32).reshape(rows.shape[0], -1)
        else:
            raise TypeError(f"{name}: {t.dtype} does not travel as int32")
        cols.append(flat)
        metas.append((name, d, t.dtype, rows.shape[1:], flat.shape[1]))
    full = all_gather_cat(torch.cat(cols, 1), group)
    out, at = {}, 0
    for name, d, dtype, tail, width in metas:
        c = full[:, at: at + width]
        at += width
        c = c != 0 if dtype == torch.bool else c.contiguous().view(dtype)
        out[name] = c.reshape((full.shape[0],) + tuple(tail)).movedim(0, d)
    return out
