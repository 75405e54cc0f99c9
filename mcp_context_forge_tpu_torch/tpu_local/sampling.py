"""Token sampling on the device: greedy / temperature / top-k / top-p, with
per-row parameters so one call serves a mixed batch."""

from __future__ import annotations

from typing import NamedTuple

import torch


class SamplingParams(NamedTuple):
    """Per-row tensors, all [B]."""

    temperature: torch.Tensor  # 0 => greedy
    top_k: torch.Tensor        # 0 => disabled
    top_p: torch.Tensor        # 1.0 => disabled


def sampling_mask(scaled: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """The top-k and nucleus masks over temperature-scaled logits [B, V]:
    True where a token stays drawable. The same comparisons as the JAX
    package's sample_tokens: top-k keeps logits >= the k-th largest (k=0
    disables), top-p keeps logits >= the smallest of the sorted prefix whose
    cumulative probability first reaches p."""
    B, V = scaled.shape
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = top_k.long().clamp(0, V)
    kth_index = torch.where(k > 0, k - 1, V - 1)
    kth_value = torch.gather(sorted_desc, 1, kth_index[:, None])
    topk_mask = torch.where((k > 0)[:, None], scaled >= kth_value, True)
    cumulative = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    cutoff_count = (cumulative < top_p[:, None]).sum(dim=-1) + 1
    cutoff_index = (cutoff_count - 1).clamp(0, V - 1)
    cutoff_value = torch.gather(sorted_desc, 1, cutoff_index[:, None])
    return topk_mask & (scaled >= cutoff_value)


def sample_tokens(logits: torch.Tensor, params: SamplingParams,
                  generator: torch.Generator,
                  any_sampled: bool = True) -> torch.Tensor:
    """logits: [B, V] f32 -> token ids [B] (int64). Greedy rows take the
    argmax (first index on ties, as jnp.argmax); the others draw from the
    masked softmax with ``generator``.

    ``any_sampled``: whether some row has a temperature above 0, which the
    caller knows on the host; False returns the argmax alone and reads
    nothing back (the call never syncs the host, so a CUDA graph can hold
    it). The draw is Gumbel-max, as ``jax.random.categorical``:
    argmax(masked logits - log E) with E ~ Exp(1) from ``generator``, the
    masked softmax's distribution (masked tokens stay at -inf)."""
    greedy = torch.argmax(logits, dim=-1)
    if not any_sampled:
        return greedy
    scaled = logits / params.temperature.clamp(min=1e-6)[:, None]
    mask = sampling_mask(scaled, params.top_k, params.top_p)
    masked = torch.where(mask, scaled, -torch.inf)
    noise = torch.empty_like(masked).exponential_(generator=generator)
    sampled = torch.argmax(masked - torch.log(noise), dim=-1)
    return torch.where(params.temperature <= 0.0, greedy, sampled)
