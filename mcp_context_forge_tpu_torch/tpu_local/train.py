"""Training: next-token cross-entropy, AdamW, and the DP×TP sharded step.

The engine's model stack is differentiable in plain PyTorch: this module
gives the training forward (with the Switch load-balancing aux loss of
routed layers), the masked cross-entropy, an AdamW set to ``optax.adamw``'s
rule, one training step, and ``build_sharded_train_step``: data parallel
over the mesh's ``data`` axis, Megatron tensor parallel over its ``model``
axis, with the JAX package's sharding rules for every parameter and both
Adam moments.

The blocks are the serving forward's (``models/llama.py`` ``PlainOps``
and ``TensorParallelOps``, here with the collectives that carry
gradients). Attention trains through its plain version
(``attn_impl="reference"``, as the JAX package trains): the hand-written kernels have no backward, and
their wrappers refuse to run where autograd would need one. A routed layer
runs what the serving trunk runs for the config: the expert scan under the
default ``moe_impl="dense"``; ``grouped`` (the plain grouped version on the
CPU) computes the same function; ``grouped_pallas`` raises under autograd,
as ``jax.grad`` of the JAX package's Pallas kernel does.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from .models.configs import LlamaConfig
from .models.llama import PlainOps, TensorParallelOps, init_params, params_logical, rms_norm
from .parallel.mesh import axis_group
from .parallel.moe import router_probs
from .parallel.sharding import shard_params


def leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a param tree, in a fixed order (dict keys sorted, as
    JAX flattens a tree)."""
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in leaves(item)]
    return [tree]


def _check_moe_impl(config: LlamaConfig) -> None:
    if (config.n_experts and config.moe_impl == "grouped_pallas"
            and torch.is_grad_enabled()):
        raise NotImplementedError(
            "moe_impl='grouped_pallas' has no backward (the JAX package's Pallas "
            "kernel neither): train with moe_impl='dense' or 'grouped'")


def _switch_aux(n_experts: int, top1_count: torch.Tensor, prob_sum: torch.Tensor,
                n_tokens: int) -> torch.Tensor:
    """E * sum_e f_e * P_e: f_e the share of tokens whose top-1 expert is
    e, P_e the mean router probability of e."""
    return n_experts * torch.sum((top1_count / n_tokens) * (prob_sum / n_tokens))


def layer_forward(layer: dict[str, Any], x: torch.Tensor, positions: torch.Tensor,
                  ops: PlainOps, attn_impl: str = "reference",
                  aux: list | None = None) -> torch.Tensor:
    """One pre-norm block: x + attention, then x + FFN. With ``aux`` (a
    list) a routed layer appends its Switch aux loss to it."""
    cfg = ops.config
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps, cfg.norm_plus_one)
    x = x + ops.attention(layer, h, positions, attn_impl)
    h = rms_norm(x, layer["ffn_norm"], cfg.norm_eps, cfg.norm_plus_one)
    if aux is not None and "router" in layer:
        probs = router_probs(layer["router"], h.reshape(-1, cfg.dim))
        aux.append(_switch_aux(cfg.n_experts, *ops.router_stats(probs)))
    return x + ops.ffn(layer, h)


def forward_logits(params: dict[str, Any], config: LlamaConfig,
                   tokens: torch.Tensor, attn_impl: str = "reference",
                   return_aux: bool = False, ops: PlainOps | None = None):
    """Plain forward (no KV cache) for training: tokens [B,S] -> logits f32
    [B,S,V]. ``return_aux=True`` also returns the Switch-style router
    load-balancing loss (E * sum_e f_e * P_e, averaged over MoE layers),
    computed inside the same forward: without it MoE fine-tuning can
    collapse routing onto a few experts. ``ops``: the blocks to run
    (default ``PlainOps(config)``; the sharded step passes its Megatron
    ones)."""
    _check_moe_impl(config)
    ops = PlainOps(config) if ops is None else ops
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = ops.embed(params["embed"], tokens)
    terms = [] if return_aux else None
    for layer in params["layers"]:
        x = layer_forward(layer, x, positions, ops, attn_impl, terms)
    x = rms_norm(x, params["final_norm"], config.norm_eps, config.norm_plus_one)
    logits = ops.head(params, x)
    if return_aux:
        aux = sum(terms, torch.zeros((), dtype=torch.float32, device=tokens.device))
        return logits, aux / max(len(terms), 1)
    return logits


def _ce_sum(logits: torch.Tensor, targets: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    logprobs = torch.log_softmax(logits, dim=-1)
    picked = logprobs.gather(-1, targets.long()[..., None])[..., 0]
    return -(picked * mask).sum()


def loss_fn(params: dict[str, Any], config: LlamaConfig, tokens: torch.Tensor,
            targets: torch.Tensor, mask: torch.Tensor,
            attn_impl: str = "reference",
            moe_aux_weight: float = 0.01) -> torch.Tensor:
    """Masked mean next-token cross-entropy, plus ``moe_aux_weight`` times
    the aux loss for a routed model."""
    if config.n_experts:
        logits, aux = forward_logits(params, config, tokens, attn_impl,
                                     return_aux=True)
    else:
        logits, aux = forward_logits(params, config, tokens, attn_impl), 0.0
    ce = _ce_sum(logits, targets, mask) / torch.clamp(mask.sum(), min=1.0)
    return ce + moe_aux_weight * aux


class TrainState(NamedTuple):
    params: Any                       # leaves are tensors with requires_grad
    optimizer: torch.optim.Optimizer  # holds both Adam moments, per leaf
    step: int


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01
                   ) -> Callable[[Any], torch.optim.Optimizer]:
    """``optax.adamw(lr, weight_decay=...)``'s rule: b1 0.9, b2 0.999, eps
    1e-8 added outside the square root, bias-corrected moments, and the
    decay decoupled from the moments on every leaf (norms included: optax
    is given no mask). Returns the optimizer's constructor over a param
    tree, as optax returns a transformation to ``init``."""
    def init(params: Any) -> torch.optim.Optimizer:
        return torch.optim.AdamW(leaves(params), lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)
    return init


def init_train_state(params: Any, optimizer: Callable[[Any], torch.optim.Optimizer]
                     ) -> TrainState:
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    return TrainState(params, optimizer(params), 0)


def train_step(state: TrainState, config: LlamaConfig, tokens: torch.Tensor,
               targets: torch.Tensor, mask: torch.Tensor,
               attn_impl: str = "reference") -> tuple[TrainState, torch.Tensor]:
    """One AdamW step on the loss; the params are updated in place.
    Returns (the next state, the loss before the step)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(state.params, config, tokens, targets, mask, attn_impl)
    loss.backward()
    state.optimizer.step()
    return TrainState(state.params, state.optimizer, state.step + 1), loss.detach()


# ------------------------------------------------------------- DP x TP step

def build_sharded_train_step(mesh, config: LlamaConfig, lr: float = 1e-4):
    """The train step over ``mesh``: DP on the batch (``data``), TP on the
    params (``model``). Returns (step, init_state):

    - ``init_state(params | generator)``: this rank's shards of a full f32
      param tree (every rank passes the same tree, or the same seeded
      generator), with AdamW (``make_optimizer(lr)``) over the shards, so
      both moments are sharded as their params;
    - ``step(state, tokens, targets, mask) -> (state, loss)``: every rank
      passes the whole batch [B, S] and takes its B / data rows. The loss is
      the whole batch's masked mean: each rank's CE sum is divided by the
      all-reduced mask count, and the gradients are summed over ``data``.

    Raises unless the mesh spans the initialized world with ``data`` and
    ``model`` axes over which the config's dims split."""
    data_group, data_index, n_data = axis_group(mesh, "data")
    model_group, model_index, n_model = axis_group(mesh, "model")
    _check_moe_impl(config)
    ops = TensorParallelOps(config, model_group, model_index, n_model, data_group, n_data)
    logical = params_logical(config)
    optimizer = make_optimizer(lr)

    def init_state(params: Any) -> TrainState:
        if isinstance(params, torch.Generator):
            params = init_params(config, params, dtype=torch.float32,
                                 device=params.device)
        return init_train_state(shard_params(params, logical, mesh), optimizer)

    def step(state: TrainState, tokens: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor) -> tuple[TrainState, torch.Tensor]:
        B, S = tokens.shape
        if B % n_data:
            raise ValueError(f"batch {B} does not split over {n_data} data ranks")
        rows = slice(data_index * (B // n_data), (data_index + 1) * (B // n_data))
        tokens, targets, mask = tokens[rows], targets[rows], mask[rows]
        count = mask.sum().detach().clone()
        dist.all_reduce(count, group=data_group)
        count = torch.clamp(count, min=1.0)
        state.optimizer.zero_grad(set_to_none=True)
        logits, aux = forward_logits(state.params, config, tokens, return_aux=True,
                                     ops=ops)
        ce = _ce_sum(logits, targets, mask)
        aux_term = 0.01 * aux if config.n_experts else 0.0   # loss_fn's default weight
        (ce / count + aux_term).backward()
        for leaf in leaves(state.params):
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
            if n_data > 1:
                dist.all_reduce(leaf.grad, group=data_group)
        state.optimizer.step()
        total = ce.detach().clone()
        dist.all_reduce(total, group=data_group)
        loss = total / count + (aux_term.detach() if config.n_experts else 0.0)
        return TrainState(state.params, state.optimizer, state.step + 1), loss

    return step, init_state
