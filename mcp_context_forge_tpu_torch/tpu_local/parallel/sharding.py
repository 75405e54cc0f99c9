"""Sharding rules: logical axis names -> partition specs -> this rank's
local slices.

1D Megatron TP over the ``model`` axis: attention QKV and FFN
up-projections shard their output dim; attention output and FFN
down-projections shard their input dim, so each block needs exactly one
all-reduce. Embedding and LM head shard the vocab dim. Norms replicate.

A spec is a tuple with one entry per leading tensor dim: the mesh axis that
dim is split over, or None (trailing dims the spec does not name are
whole), as JAX's ``PartitionSpec``. A split dim is cut into equal
contiguous blocks in mesh order, so rank r holds exactly the block JAX's
``NamedSharding`` puts on the r-th device of the same mesh shape.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh

Spec = tuple

# logical name -> spec
LOGICAL_RULES: dict[str, Spec] = {
    "replicated": (),
    "vocab_in": ("model", None),          # embedding table (vocab, dim)
    "vocab_out": (None, "model"),         # lm head (dim, vocab)
    "attn_qkv": (None, "model"),          # (dim, heads*hd) column-parallel
    "attn_out": ("model", None),          # (heads*hd, dim) row-parallel
    "ffn_up": (None, "model"),            # (dim, hidden) column-parallel
    "ffn_down": ("model", None),          # (hidden, dim) row-parallel
    # MoE stacked experts (E, dim, hidden)/(E, hidden, dim): Megatron
    # WITHIN each expert under plain TP; an 'expert'-axis mesh shards the
    # stack instead (moe.shard_moe_params)
    "moe_up": (None, None, "model"),
    "moe_down": (None, "model", None),
    "scale_moe_model": (None, "model"),   # [E, hidden] expert-stack scales
    "scale_moe": (None, None),            # [E, dim]
    # int8 per-channel scale vectors indexed by a model-sharded axis
    # (quantize.py): shard with the channels they scale
    "scale_model": ("model",),
    "kv_pages": (None, None, None, "model", None),  # (L, pages, page, kv_heads, hd)
    # int8 KV-page dequant scales (L, pages, kv_heads): shard the kv-head
    # dim with the pages they scale
    "kv_scales": (None, None, "model"),
    "activations": ("data", None, None),  # (batch, seq, dim)
    "decode_heads": ("data", None, "model", None),  # (batch, seq, heads, hd)
}


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def kv_pages_spec(mesh: DeviceMesh, n_kv_heads: int) -> Spec:
    """Paged-KV spec: kv-head dim over ``model`` when divisible, else
    replicated (GQA models whose kv heads don't divide the TP degree)."""
    if n_kv_heads % _axis_size(mesh, "model") == 0:
        return LOGICAL_RULES["kv_pages"]
    return ()


def kv_scales_spec(mesh: DeviceMesh, n_kv_heads: int) -> Spec:
    """Int8 KV scale spec: tracks ``kv_pages_spec``, so a page shard's
    scales live on the same rank as its values."""
    if n_kv_heads % _axis_size(mesh, "model") == 0:
        return LOGICAL_RULES["kv_scales"]
    return ()


def block_of(x: torch.Tensor, spec: Spec, sizes: dict[str, int],
             coords: dict[str, int]) -> torch.Tensor:
    """The block of ``x`` under ``spec`` that the rank at mesh coordinates
    ``coords`` holds on a mesh of axis ``sizes`` (by axis name; an axis the
    mesh lacks is whole): a view, no mesh or process group needed, so a
    host can cut any rank's block. Raises when a split dim does not divide
    evenly."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more dims than a {x.dim()}-d tensor")
    for dim, axis in enumerate(spec):
        if axis is None or axis not in sizes:
            continue
        n = sizes[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                             f"evenly over mesh axis {axis!r} ({n} ranks)")
        block = x.shape[dim] // n
        x = x.narrow(dim, coords[axis] * block, block)
    return x


def mesh_sizes(mesh: DeviceMesh) -> tuple[dict[str, int], dict[str, int]]:
    """(axis sizes, this rank's coordinates) of ``mesh``, by axis name."""
    names = mesh.mesh_dim_names or ()
    return ({a: mesh.size(i) for i, a in enumerate(names)},
            {a: mesh.get_local_rank(a) for a in names})


def shard_tensor(x: torch.Tensor, spec: Spec, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a copy: the full tensor
    can be freed). Raises when a split dim does not divide evenly."""
    return block_of(x, spec, *mesh_sizes(mesh)).clone()


def shard_params(params: dict[str, Any], params_logical: dict[str, Any],
                 mesh: DeviceMesh) -> dict[str, Any]:
    """This rank's local slices of a full param tree (every rank holds the
    same full tree), leaf by leaf under the logical names' rules."""
    return _tree_map(lambda x, name: shard_tensor(x, LOGICAL_RULES[name], mesh),
                     params, params_logical)


def shard_leaf(x: Any, name: Any, sizes: dict[str, int],
               coords: dict[str, int]) -> Any:
    """One leaf's block (a copy) at ``coords``: a tensor under its logical
    name's rule, or an int8 ``{"q", "s"}`` leaf under its
    ``quantize_logical`` names, each scale with the channels it scales."""
    if isinstance(x, dict):
        return {k: shard_leaf(x[k], name[k], sizes, coords) for k in x}
    return block_of(x, LOGICAL_RULES[name], sizes, coords).clone()


def _tree_map(fn, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)
