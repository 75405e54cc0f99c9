"""Device mesh construction over ``torch.distributed``.

Axes, named as in the JAX package so that callers read the same way:

- ``data``  — DP replica axis (batch-sharded training batch);
- ``model`` — TP axis: Megatron-style head/FFN sharding, and the axis the
  sequence-parallel attention (ring, Ulysses) shards the sequence over;
- a ``pipe`` or ``expert`` axis takes the place of either name for
  pipeline or expert parallelism.

One process per device: the caller initializes the default process group
(NCCL on the card, gloo on the CPU) with its address, world size and rank,
and every rank builds the same mesh. Nothing here falls back to one device:
an entry point given no group, or a group of another size, raises.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def parse_mesh_shape(spec: str) -> tuple[int, int]:
    """'1x8' -> (1, 8); raises on anything but two positive counts."""
    parts = spec.lower().replace("x", " ").split()
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"mesh shape spec must be 'DxM', got {spec!r}")
    return int(parts[0]), int(parts[1])


def mesh_shape_from_string(spec: str, n_devices: int) -> tuple[int, int]:
    """'1x8' -> (1, 8); '' -> (1, n_devices)."""
    if not spec:
        return (1, n_devices)
    data, model = parse_mesh_shape(spec)
    if data * model != n_devices:
        raise ValueError(f"mesh {data}x{model} != {n_devices} devices")
    return data, model


def make_mesh(shape: str = "", device_type: str = "cuda",
              axis_names: tuple[str, str] = ("data", "model")) -> DeviceMesh:
    """A 2-D mesh over the default process group: rank r sits at
    (r // model, r % model), the order of JAX's ``devices.reshape(data,
    model)``. Raises without an initialized group, or when the shape does
    not cover its world size."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group "
                           "(torch.distributed.init_process_group)")
    data, model = mesh_shape_from_string(shape, dist.get_world_size())
    return init_device_mesh(device_type, (data, model), mesh_dim_names=axis_names)


def axis_group(mesh: DeviceMesh | None, axis_name: str,
               size: int | None = None) -> tuple[dist.ProcessGroup, int, int]:
    """(group, this rank's index on the axis, the axis' size) of a mesh
    built over the whole initialized world. Raises on a missing mesh or
    group, a mesh that does not span the world, a missing axis, or an
    axis whose size is not ``size``."""
    if mesh is None:
        raise ValueError(f"a mesh with a {axis_name!r} axis is required")
    if not dist.is_initialized():
        raise RuntimeError("the mesh's process group is not initialized")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"mesh of {mesh.size()} ranks over a world of "
                         f"{dist.get_world_size()}")
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"mesh axes {names} have no {axis_name!r}")
    n = mesh.size(names.index(axis_name))
    if size is not None and n != size:
        raise ValueError(f"mesh axis {axis_name!r} has {n} ranks, {size} needed")
    return mesh.get_group(axis_name), mesh.get_local_rank(axis_name), n
