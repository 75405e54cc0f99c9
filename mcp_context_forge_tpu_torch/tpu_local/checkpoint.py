"""Weight checkpoints: HuggingFace safetensors directories and the port's
own saved trees.

``load_hf_llama`` maps HF tensor names onto the port's tree (weights
transposed to the [in, out] convention) for the whole config family:
Llama-3 and Mistral, Qwen2 (q/k/v ``.bias``), Gemma (decoupled head dim),
tied-embedding models whose checkpoints ship no ``lm_head.weight``, and
Mixtral, whose per-expert ``w1``/``w3``/``w2`` tensors fill the [E, ...]
stacks. Tensors stream from the shard files one at a time
(``read_safetensors``) and move to the device as they arrive, so neither
the host nor the device ever holds a second copy of the model; for a CUDA
device each is read into one reused pinned buffer (``Staging``), whose
copy to the card runs at the host's full rate.

``quant="int8"`` quantizes each tensor on the device as it arrives, over
the axis ``quantize.reduction_axis`` gives its logical name, so a loaded
tree equals ``quantize_tree`` of the same weights bit for bit. An expert
stack is quantized one expert's slice at a time (the reduction of
``moe_up``/``moe_down`` stays inside one expert) into a stack allocated at
the first slice: a bf16 Mixtral-8x7B (~93 GB) loads as int8 (~47 GB) onto
one 80 GB card. Norm weights stay float32, as ``params_from_jax`` and
``init_params`` keep them; every other full-precision leaf takes the
engine's dtype.

``save_params``/``load_params``: the port's own format is a directory
holding ``params.pt``, one ``torch.save`` of the tree (full precision or
quantized), restored memory-mapped onto the engine's device. A quantized
tree saved once restores without requantizing at every boot.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator

import torch

from .models.configs import LlamaConfig
from .models.convert import F32_LEAVES
from .models.llama import params_logical
from .quantize import quantize_leaf, reduction_axis

PARAMS_FILE = "params.pt"
# elements quantized at once: bounds the f32 temporaries of one weight
# (a Llama-3 head is 525 M elements: ~6 GB of them unblocked)
QUANT_BLOCK = 1 << 24

# safetensors dtype tags the reader accepts
_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I32": torch.int32, "I64": torch.int64,
              "U8": torch.uint8}


class Staging:
    """One host buffer, grown to the largest tensor read through it, pinned
    when ``pin``: each tensor read into it is valid until the next read."""

    def __init__(self, pin: bool = True):
        self.pin = pin
        self._buf: torch.Tensor | None = None

    def take(self, nbytes: int) -> torch.Tensor:
        if self._buf is None or self._buf.numel() < nbytes:
            self._buf = None   # free the smaller buffer first
            self._buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pin)
        return self._buf[:nbytes]


def read_safetensors(path: str, staging: Staging | None = None
                     ) -> Iterator[tuple[str, torch.Tensor]]:
    """(name, host tensor) for each tensor of one ``.safetensors`` file, in
    file order, one at a time: an 8-byte little-endian header length, a
    JSON header, then raw little-endian bytes (BF16 stays bf16: no
    widening to f32). Each tensor owns the memory it was read into, or,
    with ``staging``, is a view of the staging buffer that the next tensor
    overwrites."""
    with open(path, "rb") as fh:
        header_len = int.from_bytes(fh.read(8), "little")
        header = json.loads(fh.read(header_len))
        base = 8 + header_len
        entries = sorted(((name, meta) for name, meta in header.items()
                          if name != "__metadata__"),
                         key=lambda item: item[1]["data_offsets"][0])
        for name, meta in entries:
            dtype = _ST_DTYPES.get(meta["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name!r} has unsupported "
                                 f"dtype {meta['dtype']}")
            shape = [int(n) for n in meta["shape"]]
            start, end = meta["data_offsets"]
            numel = 1
            for n in shape:
                numel *= n
            nbytes = numel * torch.empty((), dtype=dtype).element_size()
            if end - start != nbytes:
                raise ValueError(f"{path}: tensor {name!r} spans {end - start} "
                                 f"bytes, its shape {shape} needs {nbytes}")
            if nbytes == 0:
                yield name, torch.empty(shape, dtype=dtype)
                continue
            buf = (torch.empty(nbytes, dtype=torch.uint8) if staging is None
                   else staging.take(nbytes))
            fh.seek(base + start)
            if fh.readinto(buf.numpy()) != nbytes:
                raise ValueError(f"{path}: file ends inside tensor {name!r}")
            yield name, buf.view(dtype).reshape(shape)


def _hf_key_map(config: LlamaConfig) -> dict[str, tuple]:
    """HF name -> (tree path, transpose?[, expert index]). Expert entries
    carry the index of their slice in the [E, ...] stack; ``w1``/``w3`` are
    [D, F] after the transpose, ``w2`` [F, D]."""
    mapping: dict[str, tuple] = {
        "model.embed_tokens.weight": (("embed",), False),
        "model.norm.weight": (("final_norm",), False),
    }
    if not config.tie_embeddings:
        mapping["lm_head.weight"] = (("lm_head",), True)
    for i in range(config.n_layers):
        prefix = f"model.layers.{i}."
        mapping.update({
            prefix + "input_layernorm.weight": (("layers", i, "attn_norm"), False),
            prefix + "self_attn.q_proj.weight": (("layers", i, "wq"), True),
            prefix + "self_attn.k_proj.weight": (("layers", i, "wk"), True),
            prefix + "self_attn.v_proj.weight": (("layers", i, "wv"), True),
            prefix + "self_attn.o_proj.weight": (("layers", i, "wo"), True),
            prefix + "post_attention_layernorm.weight": (("layers", i, "ffn_norm"), False),
        })
        if config.n_experts:
            mapping[prefix + "block_sparse_moe.gate.weight"] = (
                ("layers", i, "router"), True)
            for m in range(config.n_experts):
                eprefix = prefix + f"block_sparse_moe.experts.{m}."
                mapping.update({
                    eprefix + "w1.weight": (("layers", i, "w1"), True, m),
                    eprefix + "w3.weight": (("layers", i, "w3"), True, m),
                    eprefix + "w2.weight": (("layers", i, "w2"), True, m),
                })
        else:
            mapping.update({
                prefix + "mlp.gate_proj.weight": (("layers", i, "w1"), True),
                prefix + "mlp.up_proj.weight": (("layers", i, "w3"), True),
                prefix + "mlp.down_proj.weight": (("layers", i, "w2"), True),
            })
        if config.attn_bias:
            mapping.update({
                prefix + "self_attn.q_proj.bias": (("layers", i, "bq"), False),
                prefix + "self_attn.k_proj.bias": (("layers", i, "bk"), False),
                prefix + "self_attn.v_proj.bias": (("layers", i, "bv"), False),
            })
    return mapping


def _get_path(tree: Any, path: tuple) -> Any:
    for part in path:
        tree = tree[part]
    return tree


def _set_path(tree: Any, path: tuple, value: Any) -> None:
    _get_path(tree, path[:-1])[path[-1]] = value


def _walk(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) of a dict/list tree, None leaves included; a
    ``{"q", "s"}`` dict counts as one leaf."""
    if isinstance(tree, dict) and set(tree) != {"q", "s"}:
        for key, value in tree.items():
            yield from _walk(value, prefix + (key,))
    elif isinstance(tree, list):
        for i, value in enumerate(tree):
            yield from _walk(value, prefix + (i,))
    else:
        yield prefix, tree


def _place(tensor: torch.Tensor, transpose: bool, tree_path: tuple,
           axis: int | None, device: torch.device, dtype: torch.dtype) -> Any:
    """One host tensor -> its leaf on ``device``: transposed to [in, out]
    and made contiguous there, then quantized over ``axis`` (scales in
    ``dtype``) or cast (norm weights to f32, the rest to ``dtype``)."""
    w = tensor.to(device)
    if transpose:
        w = w.T.contiguous()
    if axis is not None:
        return _quantize(w, axis, dtype)
    return w.to(torch.float32 if tree_path[-1] in F32_LEAVES else dtype)


def _quantize(w: torch.Tensor, axis: int, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """``quantize_leaf(w, axis, dtype)`` of a 2-D weight, in slices of the
    kept axis of at most ``QUANT_BLOCK`` elements: the same bits, since
    each scale reads only its own slice."""
    keep = 1 - axis
    n = w.shape[keep]
    step = max(1, QUANT_BLOCK // max(1, w.shape[axis]))
    if step >= n:
        return quantize_leaf(w, axis, scale_dtype=dtype)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((n,), dtype=dtype, device=w.device)
    for start in range(0, n, step):
        size = min(step, n - start)
        part = quantize_leaf(w.narrow(keep, start, size), axis, scale_dtype=dtype)
        q.narrow(keep, start, size).copy_(part["q"])
        s[start:start + size] = part["s"]
    return {"q": q, "s": s}


def load_hf_llama(path: str, config: LlamaConfig,
                  device: torch.device | str = "cuda",
                  dtype: torch.dtype = torch.bfloat16,
                  quant: str = "") -> dict[str, Any]:
    """Every ``*.safetensors`` shard of ``path`` (in name order) into the
    port's tree on ``device``; ``quant="int8"`` quantizes on the way in.
    Tensors the config does not name are skipped; a tensor it names that
    no shard holds, or an expert stack left incomplete, raises."""
    if quant not in ("", "int8"):
        raise ValueError(f"unsupported quant mode {quant!r}")
    device = torch.device(device)
    logical = params_logical(config)
    params = _map_none(logical)
    mapping = _hf_key_map(config)
    # the copy to the device is synchronous, so one pinned buffer serves
    # every tensor; on the CPU each tensor keeps its own memory as a leaf
    staging = Staging() if device.type == "cuda" else None
    # expert stacks being filled: tree path -> (stack leaf, slices written)
    staged: dict[tuple, tuple[Any, list[bool]]] = {}
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    for fname in files:
        for key, tensor in read_safetensors(os.path.join(path, fname), staging):
            entry = mapping.get(key)
            if entry is None:
                continue
            tree_path, transpose = entry[0], entry[1]
            axis = reduction_axis(_get_path(logical, tree_path)) if quant else None
            if len(entry) == 2:
                _set_path(params, tree_path,
                          _place(tensor, transpose, tree_path, axis, device, dtype))
                continue
            expert = entry[2]
            # within one expert the stack's reduction axis is one lower
            leaf = _place(tensor, transpose, tree_path,
                          None if axis is None else axis - 1, device, dtype)
            if tree_path not in staged:
                staged[tree_path] = (_empty_stack(leaf, config.n_experts),
                                     [False] * config.n_experts)
            stack, written = staged[tree_path]
            _write_slice(stack, expert, leaf)
            written[expert] = True
            del leaf
            if all(written):
                _set_path(params, tree_path, stack)
                del staged[tree_path]
    if staged:
        raise ValueError(f"Checkpoint has incomplete expert stacks for: "
                         f"{sorted(staged)[:3]}…")
    missing = [p for p, v in _walk(params) if v is None]
    if missing:
        raise ValueError(f"Checkpoint missing tensors for: {missing[:5]}…")
    return params


def _map_none(logical: Any) -> Any:
    """The tree of ``logical`` with every leaf None."""
    if isinstance(logical, dict):
        return {k: _map_none(v) for k, v in logical.items()}
    if isinstance(logical, list):
        return [_map_none(v) for v in logical]
    return None


def _empty_stack(leaf: Any, n_experts: int) -> Any:
    if isinstance(leaf, dict):
        return {k: _empty_stack(v, n_experts) for k, v in leaf.items()}
    return torch.empty((n_experts, *leaf.shape), dtype=leaf.dtype,
                       device=leaf.device)


def _write_slice(stack: Any, expert: int, leaf: Any) -> None:
    if isinstance(stack, dict):
        for k in stack:
            stack[k][expert] = leaf[k]
    else:
        stack[expert] = leaf


def save_params(path: str, params: dict[str, Any]) -> None:
    """Write ``params`` (full precision or quantized) as the port's own
    checkpoint: the directory ``path`` holding ``params.pt``."""
    os.makedirs(path, exist_ok=True)
    torch.save(params, os.path.join(path, PARAMS_FILE))


def load_params(path: str, config: LlamaConfig,
                device: torch.device | str = "cuda",
                dtype: torch.dtype = torch.bfloat16,
                quant: str = "") -> dict[str, Any]:
    """Restore from an HF safetensors directory (quantized on the way in
    under ``quant="int8"``) or from the port's own checkpoint, which must
    already hold the tree ``quant`` asks for: a full-precision tree
    restored under ``quant="int8"`` raises a clear ``ValueError``."""
    if quant not in ("", "int8"):
        raise ValueError(f"unsupported quant mode {quant!r}")
    if os.path.isdir(path) and any(f.endswith(".safetensors")
                                   for f in os.listdir(path)):
        return load_hf_llama(path, config, device, dtype, quant=quant)
    file = os.path.join(path, PARAMS_FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"{path} holds neither *.safetensors nor "
                                f"{PARAMS_FILE}")
    device = torch.device(device)
    skeleton = expected_tree(config, dtype, quant)
    tree = torch.load(file, map_location=device, weights_only=True, mmap=True)
    try:
        return _restore(tree, skeleton)
    except ValueError as exc:
        if quant:
            raise ValueError(
                f"checkpoint at {path} does not match the quantized "
                f"({quant}) tree of {config.name}: re-save it from a "
                "quantized engine (save_params on a quant engine's params) "
                "or load the original HF safetensors directory, which "
                f"quantizes on the way in. Underlying error: {exc}") from exc
        raise ValueError(f"checkpoint at {path} does not match the tree of "
                         f"{config.name}: {exc}") from exc


def expected_tree(config: LlamaConfig, dtype: torch.dtype, quant: str = "") -> dict[str, Any]:
    """The tree ``init_params(config, ..., dtype, quant=quant)`` builds, as
    meta tensors (shapes and dtypes, no memory), from the geometry alone:
    no operation runs on the meta device, whose first use costs seconds."""
    D, F, E, hd = config.dim, config.ffn_hidden, config.n_experts, config.head_dim
    H, KV = config.n_heads * hd, config.n_kv_heads * hd
    shapes: dict[str, tuple[int, ...]] = {
        "attn_norm": (D,), "wq": (D, H), "wk": (D, KV), "wv": (D, KV), "wo": (H, D),
        "ffn_norm": (D,)}
    if E:
        shapes.update(router=(D, E), w1=(E, D, F), w3=(E, D, F), w2=(E, F, D))
    else:
        shapes.update(w1=(D, F), w3=(D, F), w2=(F, D))
    if config.attn_bias:
        shapes.update(bq=(H,), bk=(KV,), bv=(KV,))
    logical = params_logical(config)

    def leaf(name: str, shape: tuple[int, ...], logical_name: str) -> Any:
        axis = reduction_axis(logical_name) if quant else None
        if axis is None:
            return torch.empty(shape, device="meta",
                               dtype=torch.float32 if name in F32_LEAVES else dtype)
        return {"q": torch.empty(shape, dtype=torch.int8, device="meta"),
                "s": torch.empty(shape[:axis] + shape[axis + 1:], dtype=dtype,
                                 device="meta")}

    tree = {"embed": leaf("embed", (config.vocab_size, D), logical["embed"]),
            "layers": [{name: leaf(name, shape, names[name]) for name, shape in shapes.items()}
                       for names in logical["layers"]],
            "final_norm": leaf("final_norm", (D,), logical["final_norm"])}
    if not config.tie_embeddings:
        tree["lm_head"] = leaf("lm_head", (D, config.vocab_size), logical["lm_head"])
    return tree


def _restore(tree: Any, skeleton: Any, path: tuple = ()) -> Any:
    """``tree`` checked leaf by leaf against ``skeleton`` (structure and
    shapes; int8 stays int8) and cast to the skeleton's dtypes."""
    if isinstance(skeleton, dict):
        if not isinstance(tree, dict) or set(tree) != set(skeleton):
            raise ValueError(f"at {path}: expected keys {sorted(skeleton)}, "
                             f"found {sorted(tree) if isinstance(tree, dict) else type(tree).__name__}")
        return {k: _restore(tree[k], v, path + (k,)) for k, v in skeleton.items()}
    if isinstance(skeleton, list):
        if not isinstance(tree, list) or len(tree) != len(skeleton):
            raise ValueError(f"at {path}: expected a list of {len(skeleton)}")
        return [_restore(t, s, path + (i,)) for i, (t, s) in
                enumerate(zip(tree, skeleton))]
    if not isinstance(tree, torch.Tensor) or tree.shape != skeleton.shape:
        raise ValueError(f"at {path}: expected a tensor of shape "
                         f"{tuple(skeleton.shape)}, found "
                         f"{tuple(tree.shape) if isinstance(tree, torch.Tensor) else type(tree).__name__}")
    if (tree.dtype == torch.int8) != (skeleton.dtype == torch.int8):
        raise ValueError(f"at {path}: expected {skeleton.dtype}, found {tree.dtype}")
    return tree.to(skeleton.dtype)
