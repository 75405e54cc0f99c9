"""Top-k routed MoE FFN (Mixtral family): router, the drop-free expert-scan
formulation the serving trunk runs for decode-shaped batches, the
per-token reference the tests hold both formulations to, and the
capacity-dispatch FFN for expert parallelism.

Expert parallelism (``moe_ffn`` with a mesh): the stacked experts are split
over an ``expert`` mesh axis (``shard_moe_params``: each rank holds E/n
experts), tokens are replicated, every rank builds the same [T, E, C]
dispatch and combine tensors, runs its experts on its [E/n, C, D] slice of
the dispatched buffer, and the expert outputs are all-gathered before the
combine. Capacity keeps shapes static: each expert takes at most
``capacity = ceil(tokens/experts * capacity_factor)`` tokens, and overflow
tokens fall back to the residual stream (the Switch-Transformer drop
policy).

``top_k_experts`` breaks ties by the lower expert index, as
``jax.lax.top_k`` does (``torch.topk`` promises no order among equal
values): a stable descending sort, first k columns.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..quantize import is_quant, qmm
from .mesh import axis_group


@dataclass(frozen=True)
class MoEConfig:
    dim: int
    n_experts: int
    expert_hidden: int
    top_k: int = 2
    capacity_factor: float = 1.25


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


# ----------------------------------------------------- capacity dispatch (EP)

def init_moe_params(config: MoEConfig, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cuda") -> dict[str, Any]:
    """Seeded router and [E, ...] expert stacks (normal / sqrt(fan_in)).
    The draws differ from jax.random's: ``convert.moe_params_from_jax``
    carries a JAX tree across."""
    def dense(shape: tuple[int, ...], fan_in: int) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * (1.0 / math.sqrt(fan_in))).to(dtype)

    E, D, Fh = config.n_experts, config.dim, config.expert_hidden
    return {"router": dense((D, E), D), "w1": dense((E, D, Fh), D),
            "w3": dense((E, D, Fh), D), "w2": dense((E, Fh, D), Fh)}


def moe_logical() -> dict[str, str]:
    return {"router": "replicated", "w1": "expert_stack",
            "w3": "expert_stack", "w2": "expert_stack"}


def shard_moe_params(params: dict[str, Any], mesh,
                     axis_name: str = "expert") -> dict[str, Any]:
    """This rank's E/n experts (contiguous, in mesh order); the router
    replicates."""
    _, idx, n = axis_group(mesh, axis_name)
    E = params["w1"].shape[0]
    if E % n:
        raise ValueError(f"{E} experts do not split over {n} ranks")
    block = slice(idx * (E // n), (idx + 1) * (E // n))
    return {"router": params["router"],
            **{name: params[name][block].clone() for name in ("w1", "w3", "w2")}}


def _top_k_routing(logits: torch.Tensor, k: int, capacity: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (dispatch [T, E, C] 0/1, combine [T, E, C] gates).

    A token's slot in an expert's capacity buffer is its rank among the
    tokens routed to that expert (a cumsum over (token, choice) in order,
    as Switch); slots past the capacity are dropped."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    top_idx = top_k_experts(logits, k)                                  # [T, k]
    one_hot = F.one_hot(top_idx, E).to(logits.dtype)                    # [T, k, E]
    gates = probs[:, None, :] * one_hot
    # renormalize the selected gates so they sum to 1 per token
    gates = gates / torch.clamp(gates.sum(dim=(1, 2), keepdim=True), min=1e-9)
    flat = one_hot.reshape(T * k, E)
    positions = (torch.cumsum(flat, dim=0) - flat).reshape(T, k, E)
    in_capacity = (positions < capacity).to(logits.dtype)
    slot = (positions * one_hot).sum(dim=-1).long()                     # [T, k]
    # a slot past the capacity has no column (one_hot's all-zero row)
    pos_one_hot = (slot[..., None] == torch.arange(capacity, device=logits.device)
                   ).to(logits.dtype)                                   # [T, k, C]
    dispatch = torch.einsum("tke,tkc->tec", one_hot * in_capacity, pos_one_hot)
    combine = torch.einsum("tke,tkc->tec", gates * in_capacity, pos_one_hot)
    return dispatch, combine


def moe_ffn(params: dict[str, Any], x: torch.Tensor, config: MoEConfig,
            mesh=None, axis_name: str = "expert") -> torch.Tensor:
    """Capacity-dispatch SwiGLU MoE FFN. x: [B, S, D] -> [B, S, D].

    Without a mesh ``params`` hold every expert. With one they are this
    rank's (``shard_moe_params``): x is replicated, this rank runs its
    experts' slice of the dispatched buffer, and the outputs are
    all-gathered over ``axis_name`` before the combine."""
    B, S, D = x.shape
    T = B * S
    flat = x.reshape(T, D)
    capacity = max(1, int(math.ceil(T / config.n_experts * config.capacity_factor)))
    logits = (flat @ params["router"]).float()
    dispatch, combine = _top_k_routing(logits, config.top_k, capacity)
    dispatched = torch.einsum("td,tec->ecd", flat, dispatch.to(x.dtype))  # [E, C, D]
    if mesh is not None:
        group, idx, n = axis_group(mesh, axis_name)
        E_local = params["w1"].shape[0]
        if E_local * n != config.n_experts:
            raise ValueError(f"{E_local} local experts x {n} ranks != "
                             f"{config.n_experts} experts")
        dispatched = dispatched[idx * E_local:(idx + 1) * E_local]
    hidden = F.silu(torch.bmm(dispatched, params["w1"])) * torch.bmm(dispatched, params["w3"])
    expert_out = torch.bmm(hidden, params["w2"])                         # [E(/n), C, D]
    if mesh is not None:
        parts = [torch.empty_like(expert_out) for _ in range(n)]
        dist.all_gather(parts, expert_out.contiguous(), group=group)
        expert_out = torch.cat(parts)
    out = torch.einsum("ecd,tec->td", expert_out, combine.to(x.dtype))
    return out.reshape(B, S, D)
