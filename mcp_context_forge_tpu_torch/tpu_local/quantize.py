"""Int8 weight-only quantization and weight application (embedding gather,
matmuls) for the model, and the int8 primitives of the KV pages
(``kv_int8_scale``, ``kv_quantize``, ``kv_dequantize``).

Scheme (the JAX package's, ``quantize.py``): every 2D matmul weight W
becomes ``{"q": int8, "s": scale}`` with per-output-channel scales,
``W ≈ q * s`` with ``s[o] = max|W[:, o]| / 127``; the embedding table
quantizes per ROW; MoE expert stacks ``[E, D, F]`` / ``[E, F, D]``
quantize per (expert, out-channel); norms, biases and the router stay in
full precision. ``s`` is stored in ``scale_dtype`` (the engine's compute
dtype), which doubles as the activation dtype of ``embed_rows``.

``qmm`` is ``(x @ q) * s``: a plain product, which the JAX package leaves
to XLA and the port to ``torch.matmul``. XLA fuses the int8 -> bf16
convert into the dot's operand load; eager PyTorch cannot, so on the card
each call first writes a dequantized copy of ``q`` (see PERF.md). A
hand-written W8A16 GEMM is later performance work.
"""

from __future__ import annotations

from typing import Any

import torch

# logical weight name -> (reduction axis, scale logical name); the scale
# lives on the axis that survives the reduction
_QUANT_RULES: dict[str, tuple[int, str]] = {
    "vocab_in": (1, "scale_model"),    # embed (vocab, dim): per-row scale
    "vocab_out": (0, "scale_model"),   # lm head (dim, vocab): per-col scale
    "attn_qkv": (0, "scale_model"),    # (dim, H*hd)
    "attn_out": (0, "replicated"),     # (H*hd, dim)
    "ffn_up": (0, "scale_model"),      # (dim, hidden)
    "ffn_down": (0, "replicated"),     # (hidden, dim)
    # MoE expert stacks reduce the middle (contraction) axis of
    # [E, D, F] / [E, F, D]: one scale per (expert, out-channel)
    "moe_up": (1, "scale_moe_model"),
    "moe_down": (1, "scale_moe"),
}


def _map_tree(fn, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to the leaves of a dict/list tree (and the matching
    leaves of ``rest``); a ``{"q","s"}`` dict counts as one leaf."""
    if isinstance(tree, dict) and not is_quant(tree):
        return {k: _map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _leaves(tree: Any) -> list[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def reduction_axis(name: str) -> int | None:
    """The axis a weight with logical name ``name`` quantizes over (its
    scales live on the others), or None when it stays full precision."""
    rule = _QUANT_RULES.get(name)
    return None if rule is None else rule[0]


def quantize_logical(tree: Any) -> Any:
    """Map a params_logical tree to its int8 twin: quantizable leaf names
    become {"q": name, "s": scale_name} sub-dicts."""
    def one(name: str):
        rule = _QUANT_RULES.get(name)
        return name if rule is None else {"q": name, "s": rule[1]}

    return _map_tree(one, tree)


def quantize_leaf(w: torch.Tensor, axis: int,
                  scale_dtype: torch.dtype = torch.float32
                  ) -> dict[str, torch.Tensor]:
    """W -> {"q": int8, "s": scale} with scales on the non-reduced axis.
    q is computed from the f32 scale (round half to even, as
    ``jnp.round``); s is then stored in ``scale_dtype``."""
    wf = w.float()
    s = wf.abs().amax(dim=axis) / 127.0
    s = torch.clamp(s, min=1e-8)
    q = torch.round(wf / s.unsqueeze(axis)).to(torch.int8)
    return {"q": q, "s": s.to(scale_dtype)}


def quantize_tree(params: Any, logical: Any,
                  scale_dtype: torch.dtype = torch.float32) -> Any:
    """Quantize every rule-covered leaf of a full-precision tree.
    ``logical`` is the ORIGINAL (unquantized) params_logical tree."""
    def one(w, name):
        axis = reduction_axis(name)
        return w if axis is None else quantize_leaf(w, axis, scale_dtype)

    return _map_tree(one, params, logical)


def param_bytes(tree: Any) -> int:
    """Resident bytes of a param tree (quantized leaves count q and s)."""
    return sum(leaf.numel() * leaf.element_size() for leaf in _leaves(tree))


def is_quant(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def qmm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ W for a plain or quantized weight ([in, out] as in the JAX
    package): (x @ q) * s, the scale applied to the output."""
    if not is_quant(w):
        return x @ w
    return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)


def qmm_t(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ W.T (tied lm head: embed is [vocab, dim]). Per-row scales of the
    embedding are per-column scales of the head: (x @ q.T) * s."""
    if not is_quant(w):
        return x @ w.T
    return (x @ w["q"].T.to(x.dtype)) * w["s"].to(x.dtype)


def embed_rows(embed: Any, tokens: torch.Tensor,
               multiplier: float = 1.0) -> torch.Tensor:
    """Embedding gather for a plain or per-row-quantized table; quantized
    tables come back in the scale's dtype. ``multiplier`` (Gemma's
    sqrt(dim)) is rounded to the rows' dtype before it scales, as in the
    JAX package."""
    idx = tokens.long()
    if not is_quant(embed):
        rows = embed[idx]
    else:
        s = embed["s"]
        rows = embed["q"][idx].to(s.dtype) * s[idx][..., None]
    if multiplier != 1.0:
        # the multiplier rounded to the rows' dtype once, on the host; a
        # Python scalar multiplies in f32 and rounds once, the bits of the
        # product by a 0-d tensor of that dtype, with no host-to-device
        # copy (which CUDA-graph capture refuses)
        rounded = torch.tensor(multiplier, dtype=rows.dtype).item()
        rows = rows * rounded
    return rows


# ------------------------------------------------------------------- KV cache
#
# The paged KV cache quantizes per PAGE per kv-head (kv/paged_cache.py):
# symmetric int8 under a running-max scale, so every value of a page shares
# one scale and the int8-page attention kernels dequantize with one scalar
# per (page, head). The writers, the gather and the kernels all use these
# three primitives, as in the JAX package.

KV_SCALE_EPS = 1e-8  # floor under scales: all-zero pages must not divide by 0


def kv_int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """Per-(page, head) scale from a max-|value| statistic: round(x / s)
    stays inside [-127, 127] for every |x| <= amax. A true f32 division on
    every device (CUDA computes a tensor over a Python scalar as a product
    by its reciprocal, which can differ in the last bit)."""
    amax = amax.float()
    return amax / torch.full_like(amax, 127.0)


def kv_quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x -> int8 under ``scale`` (broadcast against x): f32 division by the
    floored scale, round half to even, saturate at +-127."""
    q = torch.round(x.float() / torch.clamp(scale.float(), min=KV_SCALE_EPS))
    return q.clamp(-127.0, 127.0).to(torch.int8)


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """int8 page values -> ``dtype`` (the compute dtype; scales are stored
    in it): the product is taken in f32, then rounded once."""
    return (q.float() * scale.float()).to(dtype)
