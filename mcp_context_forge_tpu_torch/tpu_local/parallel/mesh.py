"""Device mesh construction over ``torch.distributed``.

Axes, named as in the JAX package so that callers read the same way:

- ``data``  — DP replica axis (batch-sharded training batch);
- ``model`` — TP axis: Megatron-style head/FFN sharding, and the axis the
  sequence-parallel attention (ring, Ulysses) shards the sequence over;
- a ``pipe`` or ``expert`` axis takes the place of either name for
  pipeline or expert parallelism.

One process per device. Training's mesh (``make_mesh``) is a
``DeviceMesh`` over the default process group, which the caller
initializes (NCCL on the card, gloo on the CPU) with its address, world
size and rank. A serving engine's mesh (``ServingMesh``) is built from
process groups of its own, on a private store, so that one process can
hold several multi-rank engines and none touches the default group.
Nothing here falls back to one device: an entry point given no group, or
a group of another size, raises.
"""

from __future__ import annotations

from datetime import timedelta

import torch
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


def private_group(store: dist.Store, name: str, rank: int, size: int,
                  device: torch.device, timeout: timedelta) -> dist.ProcessGroup:
    """A process group of ``size`` ranks over ``store`` under the prefix
    ``name``, registered nowhere: no default group is needed, and none is
    touched. Its backend is NCCL for a CUDA ``device`` and gloo for the
    CPU. Only its members build it. The
    ``torch.distributed`` collectives take it as ``group=`` with ranks
    named within it (``group_src``, ``group_dst``); calls that translate a
    rank to a global one (``send``, ``recv``, ``P2POp``) cannot."""
    prefix = dist.PrefixStore(f"{name}/", store)
    pg = dist.ProcessGroup(prefix, rank, size)
    inner = dist.PrefixStore(f"{device.type}/", prefix)
    if device.type == "cuda":
        options = dist.ProcessGroupNCCL.Options()
        options._timeout = timeout
        impl = dist.ProcessGroupNCCL(inner, rank, size, options)
        kind = dist.ProcessGroup.BackendType.NCCL
    else:
        impl = dist.ProcessGroupGloo(inner, rank, size, timeout=timeout)
        kind = dist.ProcessGroup.BackendType.GLOO
    pg._set_default_backend(kind)
    pg._register_backend(device, kind, impl)
    pg._set_group_name(name)
    return pg


class ServingMesh:
    """A ``data`` x ``model`` mesh over an engine's own process groups:
    rank r at (r // model, r % model), as ``make_mesh`` places it. It
    answers what ``axis_group`` and ``parallel/sharding.py`` ask of a
    ``DeviceMesh`` (``get_group``, ``get_local_rank``, ``size``,
    ``mesh_dim_names``), and ``get_group("world")`` is the group of every
    rank. The groups live on ``store`` (one per engine); every rank builds
    its ``model`` group (its data row), its ``data`` group (its model
    column) and the world's."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape: tuple[int, int], rank: int, store: dist.Store,
                 device: torch.device, timeout: timedelta):
        data, model = shape
        self.shape = (data, model)
        self.rank = rank
        self.world = data * model
        row, col = divmod(rank, model)
        self._coords = {"data": row, "model": col}
        self._groups = {
            "world": private_group(store, "world", rank, self.world, device, timeout),
            "model": private_group(store, f"model{row}", col, model, device, timeout),
            "data": private_group(store, f"data{col}", row, data, device, timeout),
        }

    def get_group(self, axis: str) -> dist.ProcessGroup:
        return self._groups[axis]

    def get_local_rank(self, axis: str) -> int:
        return self._coords[axis]

    def size(self, dim: int | None = None) -> int:
        return self.world if dim is None else self.shape[dim]

    def shutdown(self) -> None:
        """Release every group's communicators (all ranks together)."""
        for group in self._groups.values():
            group.shutdown()

    def abort(self) -> None:
        """Abort every group's communicators at once (a dead peer: a
        collective waiting on it returns)."""
        for group in self._groups.values():
            group.abort()


def axis_group(mesh: DeviceMesh | ServingMesh | None, axis_name: str,
               size: int | None = None) -> tuple[dist.ProcessGroup, int, int]:
    """(group, this rank's index on the axis, the axis' size) of a mesh
    that spans its world: a ``ServingMesh``, or a ``DeviceMesh`` over the
    whole initialized default group. Raises on a missing mesh or group, a
    mesh that does not span its world, a missing axis, or an axis whose
    size is not ``size``."""
    if mesh is None:
        raise ValueError(f"a mesh with a {axis_name!r} axis is required")
    if isinstance(mesh, ServingMesh):
        world = mesh.world
    else:
        if not dist.is_initialized():
            raise RuntimeError("the mesh's process group is not initialized")
        world = dist.get_world_size()
    if mesh.size() != world:
        raise ValueError(f"mesh of {mesh.size()} ranks over a world of {world}")
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"mesh axes {names} have no {axis_name!r}")
    n = mesh.size(names.index(axis_name))
    if size is not None and n != size:
        raise ValueError(f"mesh axis {axis_name!r} has {n} ranks, {size} needed")
    return mesh.get_group(axis_name), mesh.get_local_rank(axis_name), n
