"""Carry a JAX package parameter tree across to the port.

``params_from_jax`` takes the tree as numpy arrays (what
``jax.device_get(engine.params)`` returns) and builds the port's tree of
tensors: same names, same [in, out] layouts. Norm weights stay float32, as
the JAX package keeps them; every other leaf takes ``dtype``. A pure
function on numpy input — it imports no JAX — so tests can hold both
packages to the same weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .configs import LlamaConfig

_F32_LEAVES = ("attn_norm", "ffn_norm", "final_norm")


def _tensor(arr: Any, dtype: torch.dtype, device) -> torch.Tensor:
    if isinstance(arr, dict):
        raise NotImplementedError("quantized ({'q', 's'}) leaves are not "
                                  "served by this port yet")
    a = np.asarray(arr)
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

    def leaf(name: str, arr: Any) -> torch.Tensor:
        return _tensor(arr, torch.float32 if name in _F32_LEAVES else dtype,
                       device)

    layers = []
    for layer in np_tree["layers"]:
        if "router" in layer:
            raise NotImplementedError("MoE layers are not ported yet")
        layers.append({name: leaf(name, arr) for name, arr in layer.items()})
    out = {name: leaf(name, arr) for name, arr in np_tree.items()
           if name != "layers"}
    out["layers"] = layers
    return out
