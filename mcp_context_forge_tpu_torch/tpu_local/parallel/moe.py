"""Top-k routed MoE FFN (Mixtral family): router, the drop-free expert-scan
formulation the serving trunk runs for decode-shaped batches, and the
per-token reference the tests hold both formulations to.

``top_k_experts`` breaks ties by the lower expert index, as
``jax.lax.top_k`` does (``torch.topk`` promises no order among equal
values): a stable descending sort, first k columns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ..quantize import is_quant, qmm


@dataclass(frozen=True)
class MoEConfig:
    dim: int
    n_experts: int
    expert_hidden: int
    top_k: int = 2


def top_k_experts(scores: torch.Tensor, k: int) -> torch.Tensor:
    """[T, E] -> [T, k] indices of the k largest scores per row, ties to
    the lower index."""
    return torch.argsort(scores, dim=-1, descending=True, stable=True)[:, :k]


def activation(h: torch.Tensor, act: str) -> torch.Tensor:
    """SiLU (SwiGLU) or tanh-approximate GeLU (GeGLU)."""
    return F.gelu(h, approximate="tanh") if act == "gelu" else F.silu(h)


def router_probs(router: Any, flat: torch.Tensor) -> torch.Tensor:
    """Router softmax probabilities [T, E] in f32 (a quantized router
    applies through ``qmm``)."""
    return torch.softmax(qmm(flat, router).float(), dim=-1)


def expert_slice(w: Any, e: int) -> Any:
    """Expert ``e`` of an [E, ...] stack, plain or quantized."""
    if is_quant(w):
        return {"q": w["q"][e], "s": w["s"][e]}
    return w[e]


def moe_ffn_dense_mask(params: dict[str, Any], x: torch.Tensor,
                       config: MoEConfig, act: str = "silu") -> torch.Tensor:
    """Drop-free routed FFN as a scan over EXPERTS with gate masks: every
    expert runs over all T tokens and the renormalized top-k gate zeroes
    the rest. Per-token output is independent of the batch shape; costs
    E/k x the ideal FFN FLOPs. Experts are added in index order in x's
    dtype, as the JAX scan adds them. x: [B, S, D] -> [B, S, D]."""
    B, S, D = x.shape
    flat = x.reshape(-1, D)
    probs = router_probs(params["router"], flat)                 # [T, E]
    top_idx = top_k_experts(probs, config.top_k)
    keep = F.one_hot(top_idx, config.n_experts).to(torch.float32).sum(dim=1)
    gates = probs * keep
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    gates = gates.to(x.dtype)
    acc = torch.zeros_like(flat)
    for e in range(config.n_experts):
        h = activation(qmm(flat, expert_slice(params["w1"], e)), act)
        h = qmm(h * qmm(flat, expert_slice(params["w3"], e)),
                expert_slice(params["w2"], e))                   # [T, D]
        acc = acc + gates[:, e][:, None] * h
    return acc.reshape(B, S, D)


def moe_ffn_reference(params: dict[str, Any], x: torch.Tensor,
                      config: MoEConfig) -> torch.Tensor:
    """Dense per-token loop over the selected experts (SiLU, full-precision
    stacks): the numerics oracle for tests. Gathers [T, D, F] weights, so
    tiny shapes only."""
    B, S, D = x.shape
    flat = x.reshape(-1, D)
    logits = (flat @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_idx = top_k_experts(logits, config.top_k)
    out = torch.zeros_like(flat)
    for slot in range(config.top_k):
        idx = top_idx[:, slot]
        gate = probs.gather(1, idx[:, None])[:, 0]
        hidden = (F.silu(torch.einsum("td,tdf->tf", flat, params["w1"][idx]))
                  * torch.einsum("td,tdf->tf", flat, params["w3"][idx]))
        out = out + gate[:, None] * torch.einsum("tf,tfd->td", hidden,
                                                 params["w2"][idx])
    denom = probs.gather(1, top_idx).sum(dim=1)
    out = out / torch.clamp(denom, min=1e-9)[:, None]
    return out.reshape(B, S, D)
