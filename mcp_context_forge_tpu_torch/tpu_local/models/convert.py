"""Carry a JAX package parameter tree across to the port.

``params_from_jax`` takes the tree as numpy arrays (what
``jax.device_get(engine.params)`` returns) and builds the port's tree of
tensors: same names, same [in, out] layouts, MoE router and [E, ...]
expert stacks included. Norm weights stay float32, as the JAX package keeps
them; every other full-precision leaf takes ``dtype``. A quantized leaf
(``{"q": int8, "s": scale}``) crosses unchanged: q stays int8 and s keeps
its own dtype (the JAX engine's compute dtype). A pure function on numpy
input — it imports no JAX — so tests can hold both packages to the same
weights. ``encoder_params_from_jax`` does the same for the encoder's tree
(``models/encoder.py``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .configs import EncoderConfig, LlamaConfig

F32_LEAVES = ("attn_norm", "ffn_norm", "final_norm")
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16, "int8": torch.int8}


def _tensor(arr: Any, dtype: torch.dtype | None, device) -> torch.Tensor:
    """numpy -> tensor in ``dtype`` (None: the array's own dtype)."""
    a = np.asarray(arr)
    if dtype is None:
        dtype = _TORCH_DTYPES[a.dtype.name]
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)  # ml_dtypes bfloat16 -> exact f32 widening
    # torch.tensor copies: the port never aliases (read-only) JAX buffers
    return torch.tensor(a, device=device).to(dtype)


def params_from_jax(np_tree: dict[str, Any], config: LlamaConfig,
                    device: torch.device | str = "cuda",
                    dtype: torch.dtype = torch.bfloat16) -> dict[str, Any]:
    if len(np_tree["layers"]) != config.n_layers:
        raise ValueError(f"tree has {len(np_tree['layers'])} layers, config "
                         f"{config.name} has {config.n_layers}")

    def leaf(name: str, arr: Any) -> Any:
        if isinstance(arr, dict):  # {"q": int8, "s": scale}, as they are
            return {k: _tensor(v, None, device) for k, v in arr.items()}
        return _tensor(arr, torch.float32 if name in F32_LEAVES else dtype,
                       device)

    out = {name: leaf(name, arr) for name, arr in np_tree.items()
           if name != "layers"}
    out["layers"] = [{name: leaf(name, arr) for name, arr in layer.items()}
                     for layer in np_tree["layers"]]
    return out


def encoder_params_from_jax(np_tree: dict[str, Any], config: EncoderConfig,
                            device: torch.device | str = "cuda",
                            dtype: torch.dtype = torch.float32) -> dict[str, Any]:
    """The JAX encoder tree (numpy arrays) as the port's: same names and
    [in, out] layouts; norm weights stay float32, the rest take ``dtype``."""
    if len(np_tree["layers"]) != config.n_layers:
        raise ValueError(f"tree has {len(np_tree['layers'])} layers, config "
                         f"{config.name} has {config.n_layers}")

    def leaf(name: str, arr: Any) -> torch.Tensor:
        return _tensor(arr, torch.float32 if "norm" in name else dtype, device)

    out = {name: leaf(name, arr) for name, arr in np_tree.items()
           if name != "layers"}
    out["layers"] = [{name: leaf(name, arr) for name, arr in layer.items()}
                     for layer in np_tree["layers"]]
    return out
