"""Weight application for the model: embedding gather and matmuls.

Only full-precision weights are served so far. A quantized leaf (the JAX
package's ``{"q": int8, "s": scale}`` dict) raises: int8 serving needs a
hand-written W8A16 GEMM, which comes in a later slice.
"""

from __future__ import annotations

from typing import Any

import torch


def is_quant(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def _plain(w: Any) -> torch.Tensor:
    if is_quant(w):
        raise NotImplementedError("int8 weights ({'q', 's'} leaves) are not "
                                  "served by this port yet")
    return w


def qmm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ W, W stored [in, out] as in the JAX package."""
    return x @ _plain(w)


def qmm_t(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ W.T (tied lm head: embed is [vocab, dim])."""
    return x @ _plain(w).T


def embed_rows(embed: Any, tokens: torch.Tensor,
               multiplier: float = 1.0) -> torch.Tensor:
    """Embedding gather; ``multiplier`` (Gemma's sqrt(dim)) is rounded to
    the table's dtype before it scales, as in the JAX package."""
    rows = _plain(embed)[tokens.long()]
    if multiplier != 1.0:
        rows = rows * torch.tensor(multiplier, dtype=rows.dtype,
                                   device=rows.device)
    return rows
