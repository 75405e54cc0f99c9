"""Llama-3-class decoder in PyTorch: GQA attention, RoPE (split halves),
RMSNorm, SwiGLU/GeGLU; one trunk for Llama-3, Mistral, Qwen2 (q/k/v biases),
Gemma (decoupled head_dim, GeGLU, scaled embeddings, (1+w) norms) and
Mixtral (top-k routed expert FFN, ``_ffn_block``).

Parameters are a plain dict tree with the JAX package's names and layouts
(weights [in, out], applied as ``x @ w``), so ``convert.params_from_jax``
carries a JAX tree across unchanged. Attention runs the hand-written CUDA
kernels on CUDA tensors and the plain versions on CPU tensors:

- ``prefill``: flash attention over the prompt (``ops.attention``);
- ``prefill_with_history``: the paged chunk kernel over the cached prefix
  plus the suffix just written (``ops.paged_attention``);
- ``decode_step``: the paged decode kernel, one token per row.

MoE layers run the grouped expert kernels (``ops.grouped_moe``) when a
batch clears the grouped gate and the expert scan otherwise. Weights may
be int8 (``{"q", "s"}`` leaves, ``quantize.py``). The KV writes update the
pages in place (``kv/paged_cache.py``).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from .configs import LlamaConfig
from ..kv.paged_cache import (PagedKVState, gather_kv, write_decode_kv,
                              write_prefill_kv)
from ..ops.attention import NEG_INF, causal_attention
from ..ops.grouped_moe import moe_ffn_grouped
from ..ops.paged_attention import paged_chunk_attention, paged_decode_attention
from ..parallel.moe import MoEConfig, moe_ffn_dense_mask
from ..quantize import embed_rows, qmm, qmm_t, quantize_leaf, reduction_axis


# ------------------------------------------------------------------ building blocks

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             plus_one: bool = False) -> torch.Tensor:
    """``plus_one``: Gemma checkpoints store zero-centered norm weights and
    scale by (1 + w)."""
    xf = x.float()
    normed = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    scale = weight + 1.0 if plus_one else weight
    return (normed * scale).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]. Rotates the
    two HALVES of head_dim against each other (not interleaved pairs)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # [hd/2]
    angles = positions[..., :, None].float() * freqs              # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]                      # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------------ params

def init_params(config: LlamaConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device: torch.device | str = "cuda",
                quant: str = "") -> dict[str, Any]:
    """Seeded random weights with the JAX package's shapes and scales
    (normal / sqrt(fan_in); unit norms; zero biases). The draws differ from
    jax.random's: a test that needs both packages on the same weights
    carries them across with ``convert.params_from_jax``.

    ``quant="int8"`` quantizes each weight as soon as it is drawn (in
    ``dtype`` first, as the JAX engine quantizes its ``dtype`` tree), one
    expert at a time for the [E, ...] stacks, so the full-precision tree
    never exists: Mixtral-8x7B is ~93 GB in bf16 and ~47 GB in int8. The
    draws are the same either way, so the result equals
    ``quantize_tree(init_params(...), params_logical(config), dtype)``."""
    if quant not in ("", "int8"):
        raise ValueError(f"unsupported quant mode {quant!r}")
    logical = params_logical(config)

    def draw(shape: tuple[int, ...], fan_in: int) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * (1.0 / math.sqrt(fan_in))).to(dtype)

    def dense(name: str, shape: tuple[int, ...], fan_in: int) -> Any:
        axis = reduction_axis(name) if quant else None
        w = draw(shape, fan_in)
        return w if axis is None else quantize_leaf(w, axis, dtype)

    def stack(name: str, shape: tuple[int, ...], fan_in: int) -> Any:
        """[E, *shape], drawn (and quantized) one expert at a time."""
        E = config.n_experts
        axis = reduction_axis(name) if quant else None
        if axis is None:
            out = torch.empty((E, *shape), dtype=dtype, device=device)
            for e in range(E):
                out[e] = draw(shape, fan_in)
            return out
        axis -= 1   # the stack's reduction axis, within one expert
        q = torch.empty((E, *shape), dtype=torch.int8, device=device)
        s = torch.empty((E, shape[1 - axis]), dtype=dtype, device=device)
        for e in range(E):
            leaf = quantize_leaf(draw(shape, fan_in), axis, dtype)
            q[e], s[e] = leaf["q"], leaf["s"]
        return {"q": q, "s": s}

    def norm() -> torch.Tensor:
        return torch.ones((config.dim,), dtype=torch.float32, device=device)

    hd, D, Fh = config.head_dim, config.dim, config.ffn_hidden
    names = logical["layers"][0] if config.n_layers else {}
    layers = []
    for _ in range(config.n_layers):
        layer = {
            "attn_norm": norm(),
            "wq": dense(names["wq"], (D, config.n_heads * hd), D),
            "wk": dense(names["wk"], (D, config.n_kv_heads * hd), D),
            "wv": dense(names["wv"], (D, config.n_kv_heads * hd), D),
            "wo": dense(names["wo"], (config.n_heads * hd, D),
                        config.n_heads * hd),
            "ffn_norm": norm(),
        }
        if config.n_experts:  # Mixtral: router + stacked expert FFN
            layer["router"] = dense(names["router"], (D, config.n_experts), D)
            layer["w1"] = stack(names["w1"], (D, Fh), D)
            layer["w3"] = stack(names["w3"], (D, Fh), D)
            layer["w2"] = stack(names["w2"], (Fh, D), Fh)
        else:
            layer["w1"] = dense(names["w1"], (D, Fh), D)
            layer["w3"] = dense(names["w3"], (D, Fh), D)
            layer["w2"] = dense(names["w2"], (Fh, D), Fh)
        if config.attn_bias:  # Qwen2-style q/k/v projection biases
            for name, width in (("bq", config.n_heads), ("bk", config.n_kv_heads),
                                ("bv", config.n_kv_heads)):
                layer[name] = torch.zeros((width * hd,), dtype=dtype,
                                          device=device)
        layers.append(layer)
    params = {
        "embed": dense(logical["embed"], (config.vocab_size, D), D),
        "layers": layers,
        "final_norm": norm(),
    }
    if not config.tie_embeddings:
        params["lm_head"] = dense(logical["lm_head"], (D, config.vocab_size),
                                  D)
    return params


def params_logical(config: LlamaConfig) -> dict[str, Any]:
    """Logical names matching init_params' tree (the JAX package's; they
    select the quantization rule of each leaf)."""
    layer = {
        "attn_norm": "replicated",
        "wq": "attn_qkv", "wk": "attn_qkv", "wv": "attn_qkv",
        "wo": "attn_out",
        "ffn_norm": "replicated",
    }
    if config.n_experts:
        layer.update({"router": "replicated", "w1": "moe_up",
                      "w3": "moe_up", "w2": "moe_down"})
    else:
        layer.update({"w1": "ffn_up", "w3": "ffn_up", "w2": "ffn_down"})
    if config.attn_bias:
        layer.update({"bq": "replicated", "bk": "replicated",
                      "bv": "replicated"})
    tree = {
        "embed": "vocab_in",
        "layers": [dict(layer) for _ in range(config.n_layers)],
        "final_norm": "replicated",
    }
    if not config.tie_embeddings:
        tree["lm_head"] = "vocab_out"
    return tree


def param_count(config: LlamaConfig) -> int:
    hd = config.head_dim
    if config.n_experts:
        ffn = (config.n_experts * 3 * config.dim * config.ffn_hidden
               + config.dim * config.n_experts)   # experts + router
    else:
        ffn = 3 * config.dim * config.ffn_hidden
    per_layer = (config.dim * (config.n_heads + 2 * config.n_kv_heads) * hd
                 + config.n_heads * hd * config.dim
                 + ffn + 2 * config.dim)
    if config.attn_bias:
        per_layer += (config.n_heads + 2 * config.n_kv_heads) * hd
    embeddings = config.vocab_size * config.dim * (
        1 if config.tie_embeddings else 2)
    return embeddings + config.dim + config.n_layers * per_layer


def lm_logits(params: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Hidden states -> f32 vocab logits; tied models reuse embed.T."""
    head = params.get("lm_head")
    if head is None:
        return qmm_t(x, params["embed"]).float()
    return qmm(x, head).float()


# ----------------------------------------------------------------------- forward

def _attention_block(layer: dict[str, Any], config: LlamaConfig,
                     x: torch.Tensor, positions: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B,S,D] -> q [B,S,H,hd], k/v [B,S,KV,hd], with RoPE on q and k."""
    B, S, _ = x.shape
    hd = config.head_dim
    q = qmm(x, layer["wq"])
    k = qmm(x, layer["wk"])
    v = qmm(x, layer["wv"])
    if "bq" in layer:
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    q = apply_rope(q.reshape(B, S, config.n_heads, hd), positions,
                   config.rope_theta)
    k = apply_rope(k.reshape(B, S, config.n_kv_heads, hd), positions,
                   config.rope_theta)
    return q, k, v.reshape(B, S, config.n_kv_heads, hd)


def _ffn(layer: dict[str, Any], x: torch.Tensor,
         act: str = "silu") -> torch.Tensor:
    gate = qmm(x, layer["w1"])
    gate = (F.gelu(gate, approximate="tanh") if act == "gelu"
            else F.silu(gate))  # GeGLU (Gemma) vs SwiGLU
    return qmm(gate * qmm(x, layer["w3"]), layer["w2"])


def _ffn_block(layer: dict[str, Any], config: LlamaConfig,
               x: torch.Tensor) -> torch.Tensor:
    """Dense SwiGLU/GeGLU, or the top-k routed MoE FFN when the layer has a
    router (Mixtral family).

    MoE layers take the grouped path (``ops.grouped_moe``: the hand-written
    kernels on CUDA tensors) only when ``T*k >= E*moe_block``, T = B*S
    INCLUDING padding rows: its padded rows are bounded by T*k + E*block
    against the expert scan's E*T. Prefill clears the gate; decode
    (T = batch width) never does and runs the expert scan. ``grouped`` and
    ``grouped_pallas`` take the same kernels here: the JAX package's
    ``grouped`` (XLA-gathered weights) exists only because XLA cannot
    express the kernel."""
    if "router" not in layer:
        return _ffn(layer, x, config.hidden_act)
    moe_cfg = MoEConfig(dim=config.dim, n_experts=config.n_experts,
                        expert_hidden=config.ffn_hidden,
                        top_k=config.moe_top_k)
    moe_params = {k: layer[k] for k in ("router", "w1", "w3", "w2")}
    T = x.shape[0] * x.shape[1]
    if (config.moe_impl.startswith("grouped")
            and T * config.moe_top_k >= config.n_experts * config.moe_block):
        return moe_ffn_grouped(moe_params, x, moe_cfg, act=config.hidden_act,
                               block=config.moe_block)
    return moe_ffn_dense_mask(moe_params, x, moe_cfg, act=config.hidden_act)


def prefill(params: dict[str, Any], config: LlamaConfig, tokens: torch.Tensor,
            positions: torch.Tensor, kv: PagedKVState, slot_ids: torch.Tensor,
            last_idx: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, PagedKVState]:
    """Full-sequence forward writing KV into the paged cache.

    tokens/positions: [B, S] (padding has position -1); slot_ids: [B].
    ``last_idx`` ([B]): only those positions go through the lm head,
    returning [B, vocab] — serving needs one distribution per row, and
    [B, S, vocab] f32 logits would be gigabytes at a 128k vocab.
    Returns (logits [B, S, V] or [B, V] f32, kv)."""
    x = embed_rows(params["embed"], tokens, config.embed_multiplier)
    mask_valid = positions >= 0
    safe_positions = positions.clamp(min=0)
    for idx, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], config.norm_eps, config.norm_plus_one)
        q, k, v = _attention_block(layer, config, h, safe_positions)
        write_prefill_kv(kv, idx, k, v, slot_ids, safe_positions, mask_valid)
        attn = causal_attention(q, k, v, mask_valid)              # [B,S,H,hd]
        x = x + qmm(attn.reshape(*attn.shape[:2], -1), layer["wo"])
        h = rms_norm(x, layer["ffn_norm"], config.norm_eps, config.norm_plus_one)
        x = x + _ffn_block(layer, config, h)
    x = rms_norm(x, params["final_norm"], config.norm_eps, config.norm_plus_one)
    if last_idx is not None:
        x = x[torch.arange(x.shape[0], device=x.device), last_idx.long()]
    return lm_logits(params, x), kv


def prefill_with_history(params: dict[str, Any], config: LlamaConfig,
                         tokens: torch.Tensor, positions: torch.Tensor,
                         kv: PagedKVState, slot_ids: torch.Tensor,
                         last_idx: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, PagedKVState]:
    """Suffix prefill attending over cached history (prefix-cache hit).

    tokens/positions: [B, S] with ABSOLUTE positions (a row sharing ``hist``
    cached tokens starts at position ``hist``); padding has position -1.
    The row's block table must already map its history pages. Attention is
    causal by absolute position (cache position c attends iff c <= q_pos),
    so rows with different history lengths share one call. The kernel walks
    only the pages a row uses, so no context-width bucket is needed.
    Returns (logits [B,S,V] or [B,V] f32, kv)."""
    B, S = tokens.shape
    x = embed_rows(params["embed"], tokens, config.embed_multiplier)
    mask_valid = positions >= 0
    safe_positions = positions.clamp(min=0)
    KV, hd = config.n_kv_heads, config.head_dim
    G = config.n_heads // KV
    tile = _history_tile(S, G)
    on_card = kv.k_pages.is_cuda
    tables = kv.block_tables[slot_ids.long()]
    for idx, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], config.norm_eps, config.norm_plus_one)
        q, k, v = _attention_block(layer, config, h, safe_positions)
        write_prefill_kv(kv, idx, k, v, slot_ids, safe_positions, mask_valid)
        if not on_card:
            keys, values = gather_kv(kv, idx, slot_ids)
        tiles = []
        for t0 in range(0, S, tile):
            qs = q[:, t0:t0 + tile]
            if on_card:
                at = paged_chunk_attention(
                    qs.reshape(B, -1, KV, G, hd).contiguous(),
                    kv.k_pages[idx], kv.v_pages[idx], tables,
                    positions[:, t0:t0 + tile].contiguous())
                at = at.reshape(B, -1, config.n_heads, hd)
            else:
                at = _history_attention(qs, keys, values,
                                        safe_positions[:, t0:t0 + tile],
                                        mask_valid[:, t0:t0 + tile], config)
            tiles.append(at)
        attn = tiles[0] if len(tiles) == 1 else torch.cat(tiles, dim=1)
        x = x + qmm(attn.reshape(B, S, -1), layer["wo"])
        h = rms_norm(x, layer["ffn_norm"], config.norm_eps, config.norm_plus_one)
        x = x + _ffn_block(layer, config, h)
    x = rms_norm(x, params["final_norm"], config.norm_eps, config.norm_plus_one)
    if last_idx is not None:
        x = x[torch.arange(B, device=x.device), last_idx.long()]
    return lm_logits(params, x), kv


def _history_tile(S: int, G: int) -> int:
    """Query-tile width for chunk/history attention: at most 2048/G query
    heads' worth of rows per call (bounding the plain path's [B,KV,G,T,C]
    f32 scores). S and the tile are powers of two, so the tile divides S."""
    tile = max(128, 2048 // max(1, G))
    t = 128
    while t * 2 <= min(tile, S):
        t *= 2
    return min(t, S)


def _history_attention(q: torch.Tensor, keys: torch.Tensor,
                       values: torch.Tensor, positions: torch.Tensor,
                       valid: torch.Tensor, config: LlamaConfig
                       ) -> torch.Tensor:
    """Plain chunk attention over the gathered context (history + chunk).

    q: [B,S,H,hd]; keys/values: [B,C,KV,hd]; positions/valid: [B,S].
    Cache index c attends iff c <= q_position. -> [B,S,H,hd]."""
    B, S, H, hd = q.shape
    C = keys.shape[1]
    qg = q.reshape(B, S, config.n_kv_heads, H // config.n_kv_heads, hd).float()
    scores = torch.einsum("bskgh,bckh->bkgsc", qg, keys.float()) / math.sqrt(hd)
    cache_pos = torch.arange(C, device=q.device)[None, None, :]   # [1,1,C]
    ok = (cache_pos <= positions[:, :, None]) & valid[:, :, None]  # [B,S,C]
    scores = torch.where(ok[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgsc,bckh->bskgh", probs, values.float())
    return out.reshape(B, S, H, hd).to(values.dtype)


def decode_step(params: dict[str, Any], config: LlamaConfig,
                tokens: torch.Tensor, positions: torch.Tensor,
                kv: PagedKVState, slot_ids: torch.Tensor,
                seq_lens: torch.Tensor,
                write_mask: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, PagedKVState]:
    """One decode step over the paged cache.

    tokens/positions: [B] this step's input token and its position;
    slot_ids: [B] block-table rows; seq_lens: [B] tokens in cache including
    this one after its write; write_mask: [B] bool — False rows write to the
    trash page. The kernel reads only each row's ceil(seq_len/page) pages,
    so no context-width bucket is needed. Returns (logits [B,V] f32, kv)."""
    B = tokens.shape[0]
    KV, hd = config.n_kv_heads, config.head_dim
    G = config.n_heads // KV
    x = embed_rows(params["embed"], tokens, config.embed_multiplier)[:, None, :]
    pos = positions[:, None]
    on_card = kv.k_pages.is_cuda
    tables = kv.block_tables[slot_ids.long()]
    for idx, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], config.norm_eps, config.norm_plus_one)
        q, k, v = _attention_block(layer, config, h, pos)
        write_decode_kv(kv, idx, k[:, 0], v[:, 0], slot_ids, positions,
                        valid=write_mask)
        if on_card:
            attn = paged_decode_attention(
                q[:, 0].reshape(B, KV, G, hd), kv.k_pages[idx],
                kv.v_pages[idx], tables, seq_lens)
        else:
            keys, values = gather_kv(kv, idx, slot_ids)
            attn = _paged_decode_attention(q[:, 0], keys, values, seq_lens,
                                           config)
        x = x + qmm(attn.reshape(B, 1, -1), layer["wo"])
        h = rms_norm(x, layer["ffn_norm"], config.norm_eps, config.norm_plus_one)
        x = x + _ffn_block(layer, config, h)
    x = rms_norm(x, params["final_norm"], config.norm_eps, config.norm_plus_one)
    return lm_logits(params, x[:, 0]), kv


def _paged_decode_attention(q: torch.Tensor, keys: torch.Tensor,
                            values: torch.Tensor, seq_lens: torch.Tensor,
                            config: LlamaConfig) -> torch.Tensor:
    """Plain decode attention over the gathered context.
    q: [B,H,hd]; keys/values: [B,C,KV,hd]; seq_lens: [B] -> [B,1,H,hd]."""
    B, H, hd = q.shape
    C = keys.shape[1]
    qg = q.reshape(B, config.n_kv_heads, H // config.n_kv_heads, hd).float()
    scores = torch.einsum("bkgh,bckh->bkgc", qg, keys.float()) / math.sqrt(hd)
    valid = torch.arange(C, device=q.device)[None, :] < seq_lens[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgc,bckh->bkgh", probs, values.float())
    return out.reshape(B, 1, H, hd).to(values.dtype)
