"""Small bidirectional transformer encoder for embeddings and moderation.

The provider's ``embed`` (mean-pooled, L2-normalized sentence vectors) and
``classify`` (a 2-class harm head on the pooled vector) run it. The JAX
package computes it in plain ``jnp``, outside any Pallas kernel, so here
it is plain PyTorch (``torch.matmul``, ``torch.softmax``): layer norm,
masked softmax attention over the whole sequence, a GELU FFN (tanh
approximation, as ``jax.nn.gelu``), masked mean pooling, L2 norm and the
class head.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from .configs import EncoderConfig


def init_encoder_params(config: EncoderConfig, generator: torch.Generator,
                        dtype: torch.dtype = torch.float32,
                        device: torch.device | str = "cuda") -> dict[str, Any]:
    """Seeded random weights with the JAX package's shapes and scales
    (normal / sqrt(fan_in), unit norms); the draws differ from jax.random's
    (``convert.encoder_params_from_jax`` carries a JAX tree across)."""
    D, Fh = config.dim, config.ffn_hidden

    def dense(shape: tuple[int, ...], fan_in: int) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * (1.0 / math.sqrt(fan_in))).to(dtype)

    def norm() -> torch.Tensor:
        return torch.ones((D,), dtype=torch.float32, device=device)

    layers = [{"norm1": norm(), "wqkv": dense((D, 3 * D), D),
               "wo": dense((D, D), D), "norm2": norm(),
               "w1": dense((D, Fh), D), "w2": dense((Fh, D), Fh)}
              for _ in range(config.n_layers)]
    return {
        "embed": dense((config.vocab_size, D), D),
        "pos_embed": dense((config.max_seq_len, D), D),
        "layers": layers,
        "final_norm": norm(),
        "cls_head": dense((D, config.n_classes), D),
    }


def _layer_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * weight


def encode(params: dict[str, Any], config: EncoderConfig, tokens: torch.Tensor,
           mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] int, mask [B, S] bool -> (embeddings [B, D],
    L2-normalized; class logits [B, n_classes])."""
    B, S = tokens.shape
    H = config.n_heads
    hd = config.dim // H
    x = params["embed"][tokens] + params["pos_embed"][:S][None]
    bias = torch.zeros(mask.shape, dtype=x.dtype, device=x.device)
    bias = bias.masked_fill(~mask, -1e30)[:, None, None, :]        # [B, 1, 1, S]
    for layer in params["layers"]:
        h = _layer_norm(x, layer["norm1"], config.norm_eps)
        q, k, v = (h @ layer["wqkv"]).split(config.dim, dim=-1)
        q, k, v = (t.reshape(B, S, H, hd).transpose(1, 2) for t in (q, k, v))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd) + bias
        attn = torch.softmax(scores, dim=-1) @ v                  # [B, H, S, hd]
        x = x + attn.transpose(1, 2).reshape(B, S, config.dim) @ layer["wo"]
        h = _layer_norm(x, layer["norm2"], config.norm_eps)
        x = x + F.gelu(h @ layer["w1"], approximate="tanh") @ layer["w2"]
    x = _layer_norm(x, params["final_norm"], config.norm_eps)
    weights = mask.to(x.dtype)[:, :, None]
    pooled = (x * weights).sum(dim=1) / weights.sum(dim=1).clamp_min(1.0)
    embeddings = pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    return embeddings, pooled @ params["cls_head"]
