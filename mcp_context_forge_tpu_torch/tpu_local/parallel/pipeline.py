"""Pipeline parallelism: layer stages over a ``pipe`` mesh axis (GPipe).

- layer params are STACKED with a leading stage axis
  ([n_stages, layers_per_stage, ...]); ``shard_stacked`` keeps this rank's
  stage, so each rank holds only its stage's weights;
- the batch splits into M microbatches; activations go stage -> stage with
  ``send``/``recv``, M + n_stages - 1 steps in all, so every stage is busy
  once the pipeline fills;
- embedding and the LM head run outside the pipelined middle, replicated
  on every rank: the last stage's outputs are broadcast to every rank.

Forward only, as the JAX package's.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ..models.configs import LlamaConfig
from ..models.llama import rms_norm
from ..quantize import embed_rows
from ..train import PlainOps, layer_forward
from .mesh import axis_group


def stack_layers(params: dict[str, Any], n_stages: int) -> dict[str, Any]:
    """layers[L][name] -> stages[name] of shape [n_stages, L/n_stages, ...].
    Returns {embed, final_norm, lm_head, stages}; a tied model's lm_head is
    its embedding (transposed where it projects)."""
    layers = params["layers"]
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers not divisible by {n_stages} stages")
    per_stage = len(layers) // n_stages
    stacked = {name: torch.stack([
        torch.stack([layers[s * per_stage + i][name] for i in range(per_stage)])
        for s in range(n_stages)]) for name in layers[0]}
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "lm_head": params.get("lm_head", params["embed"]), "stages": stacked}


def _stage_forward(stage_layers: dict[str, Any], config: LlamaConfig,
                   x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Apply this rank's layers_per_stage layers in order (the training
    forward's layer body, attention through its plain version)."""
    ops = PlainOps(config)
    for i in range(stage_layers["wq"].shape[0]):
        x = layer_forward({name: arr[i] for name, arr in stage_layers.items()},
                          x, positions, ops)
    return x


def _pipeline_body(my_layers: dict[str, Any], x_mb: torch.Tensor,
                   positions: torch.Tensor, config: LlamaConfig,
                   group) -> torch.Tensor:
    """Per-rank GPipe schedule. my_layers: this stage's [per_stage, ...]
    stacks; x_mb: [M, mb, S, D] microbatched embeddings (replicated).
    Returns the last stage's [M, mb, S, D] outputs, on every rank.

    At step t stage s runs microbatch t - s (when it exists): stage 0 takes
    it from x_mb, the others receive it from stage s - 1, which sent it at
    step t - 1; the last stage keeps its outputs."""
    n, stage = dist.get_world_size(group), dist.get_rank(group)
    M = x_mb.shape[0]
    outputs = torch.zeros_like(x_mb)
    for t in range(M + n - 1):
        mb = t - stage
        if not 0 <= mb < M:
            continue                       # filling or draining
        if stage == 0:
            x = x_mb[mb]
        else:
            x = torch.empty_like(x_mb[0])
            dist.recv(x, dist.get_global_rank(group, stage - 1), group=group)
        out = _stage_forward(my_layers, config, x, positions)
        if stage < n - 1:
            dist.send(out.contiguous(), dist.get_global_rank(group, stage + 1), group=group)
        else:
            outputs[mb] = out
    # every rank gets the last stage's outputs (the head is replicated)
    dist.broadcast(outputs, dist.get_global_rank(group, n - 1), group=group)
    return outputs


def build_pp_forward(mesh, config: LlamaConfig, n_stages: int, microbatches: int,
                     axis_name: str = "pipe"):
    """Returns (forward, shard_stacked):

    - ``shard_stacked(stacked)`` keeps this rank's stage of stage-stacked
      params ({name: [per_stage, ...]}); embed, final norm and head stay
      whole;
    - ``forward(local, tokens, positions) -> logits [B, S, vocab]`` f32 on
      every rank: embed -> pipelined layers (M microbatches) -> final norm
      and head. B must divide by ``microbatches``.
    Raises unless ``mesh``'s ``axis_name`` has ``n_stages`` ranks."""
    group, stage, _ = axis_group(mesh, axis_name, size=n_stages)

    def shard_stacked(stacked: dict[str, Any]) -> dict[str, Any]:
        stages = stacked["stages"]
        if stages["wq"].shape[0] != n_stages:
            raise ValueError(f"params stacked for {stages['wq'].shape[0]} stages, "
                             f"the mesh has {n_stages}")
        return {"embed": stacked["embed"], "final_norm": stacked["final_norm"],
                "lm_head": stacked["lm_head"],
                "stages": {name: arr[stage].clone() for name, arr in stages.items()}}

    def forward(local: dict[str, Any], tokens: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        if B % microbatches:
            raise ValueError(f"batch {B} not divisible by {microbatches} microbatches")
        mb = B // microbatches
        x = embed_rows(local["embed"], tokens, config.embed_multiplier)  # [B, S, D]
        x_mb = x.reshape(microbatches, mb, S, -1)
        out = _pipeline_body(local["stages"], x_mb, positions[:mb], config, group)
        x = rms_norm(out.reshape(B, S, -1), local["final_norm"], config.norm_eps,
                     config.norm_plus_one)
        head = local["lm_head"].T if config.tie_embeddings else local["lm_head"]
        return (x @ head).float()

    return forward, shard_stacked
