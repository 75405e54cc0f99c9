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
  (or the chunks of a long prompt already written) plus the span just
  written (``ops.paged_attention``);
- ``decode_step``: the paged decode kernel, one token per row.

On an int8 KV pool the two paged kernels are their int8-page variants,
handed each layer's page scales; cold ``prefill`` attends over its own
fresh k/v and only stores them quantized. The CPU path reads int8 pages
through ``gather_kv``, which dequantizes into the compute dtype.

MoE layers run the grouped expert kernels (``ops.grouped_moe``) when a
batch clears the grouped gate and the expert scan otherwise. Weights may
be int8 (``{"q", "s"}`` leaves, ``quantize.py``). The KV writes update the
pages in place (``kv/paged_cache.py``).

Tensor parallelism: given a ``mesh`` (``parallel/mesh.py``), the three
forwards run Megatron blocks on this rank's shards of the tree
(``parallel/sharding.py``'s rules): column-parallel wq/wk/wv/w1/w3,
row-parallel wo/w2 with one all-reduce per block, a vocab-split embedding
(one all-reduce) and head (its logits all-gathered), each expert's hidden
dim split. The blocks are ``TensorParallelOps``, which the trainer
(``train.py``) shares with its autograd collectives; serving takes the
plain ones (``ServingOps``). The serving kernels then run on this rank's
query heads over its KV pool: its KV heads when they split over the
``model`` axis, else every KV head (a replicated pool), of which its
query heads read a window (the kernels' ``kv_offset``). ``attn_impl``
``ring``/``ulysses`` runs a cold prefill's attention sequence-parallel
over the ``model`` axis (``ops.attention.causal_attention``), on every
query and KV head, as the JAX package's ``shard_map`` does.
"""

from __future__ import annotations

import math
import weakref
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .configs import LlamaConfig
from ..kv.paged_cache import (PagedKVState, gather_kv, write_decode_kv,
                              write_prefill_kv)
from ..ops.attention import NEG_INF, causal_attention
from ..ops.grouped_moe import moe_ffn_grouped
from ..ops.paged_attention import paged_chunk_attention, paged_decode_attention
from ..parallel.collectives import (all_gather_last, all_reduce_, copy_to, gather_from,
                                    reduce_from)
from ..parallel.mesh import axis_group
from ..parallel.moe import MoEConfig, activation, moe_ffn_dense_mask, router_probs, top_k_experts
from ..quantize import (embed_rows, qmm, qmm_t, quantize_leaf, quantize_logical,
                        reduction_axis)


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
                quant: str = "", place=None) -> dict[str, Any]:
    """Seeded random weights with the JAX package's shapes and scales
    (normal / sqrt(fan_in); unit norms; zero biases). The draws differ from
    jax.random's: a test that needs both packages on the same weights
    carries them across with ``convert.params_from_jax``.

    ``quant="int8"`` quantizes each weight as soon as it is drawn (in
    ``dtype`` first, as the JAX engine quantizes its ``dtype`` tree), one
    expert at a time for the [E, ...] stacks, so the full-precision tree
    never exists: Mixtral-8x7B is ~93 GB in bf16 and ~47 GB in int8. The
    draws are the same either way, so the result equals
    ``quantize_tree(init_params(...), params_logical(config), dtype)``.

    ``place(leaf, logical_name)``: what to keep of each leaf as soon as it
    is drawn (and quantized), e.g. a tensor-parallel rank's block of it
    (``ranks.py``); ``logical_name`` is ``quantize_logical``'s for an int8
    leaf. The draws are those of the whole tree, so the blocks kept are
    blocks of the tree ``place=None`` returns, while at most one whole
    leaf exists at a time."""
    if quant not in ("", "int8"):
        raise ValueError(f"unsupported quant mode {quant!r}")
    logical = params_logical(config)

    def kept(leaf: Any, name: str) -> Any:
        if place is None:
            return leaf
        return place(leaf, quantize_logical(name) if isinstance(leaf, dict) else name)

    def draw(shape: tuple[int, ...], fan_in: int) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * (1.0 / math.sqrt(fan_in))).to(dtype)

    def dense(name: str, shape: tuple[int, ...], fan_in: int) -> Any:
        axis = reduction_axis(name) if quant else None
        w = draw(shape, fan_in)
        return kept(w if axis is None else quantize_leaf(w, axis, dtype), name)

    def stack(name: str, shape: tuple[int, ...], fan_in: int) -> Any:
        """[E, *shape], drawn (and quantized) one expert at a time."""
        E = config.n_experts
        axis = reduction_axis(name) if quant else None
        if axis is None:
            out = torch.empty((E, *shape), dtype=dtype, device=device)
            for e in range(E):
                out[e] = draw(shape, fan_in)
            return kept(out, name)
        axis -= 1   # the stack's reduction axis, within one expert
        q = torch.empty((E, *shape), dtype=torch.int8, device=device)
        s = torch.empty((E, shape[1 - axis]), dtype=dtype, device=device)
        for e in range(E):
            leaf = quantize_leaf(draw(shape, fan_in), axis, dtype)
            q[e], s[e] = leaf["q"], leaf["s"]
        return kept({"q": q, "s": s}, name)

    def norm() -> torch.Tensor:
        return kept(torch.ones((config.dim,), dtype=torch.float32, device=device),
                    "replicated")

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
                layer[name] = kept(torch.zeros((width * hd,), dtype=dtype,
                                               device=device), "replicated")
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


class PlainOps:
    """The pieces of the forward that tensor parallelism replaces (the
    embedding, the attention projections and output, the FFN, the
    router's token statistics and the head), on one device's whole
    tensors. ``kv_groups`` KV groups of query heads read the pool's heads
    from ``kv_offset`` on: here all of them."""

    def __init__(self, config: LlamaConfig):
        self.config = config
        self.kv_groups = config.n_kv_heads
        self.kv_offset = 0

    def embed(self, table: Any, tokens: torch.Tensor) -> torch.Tensor:
        return embed_rows(table, tokens, self.config.embed_multiplier)

    def project(self, layer: dict[str, Any], h: torch.Tensor, positions: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q [B,S,H_local,hd] and the k/v [B,S,KV_pool,hd] the KV pool
        stores, with RoPE on q and k."""
        return _attention_block(layer, self.config, h, positions)

    def window(self, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Of fresh k/v, the heads this device's query heads read."""
        return k, v

    def prefill_attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor, attn_impl: str, mesh) -> torch.Tensor:
        k, v = self.window(k, v)
        return causal_attention(q, k, v, valid, impl=attn_impl, mesh=mesh)

    def out(self, layer: dict[str, Any], attn: torch.Tensor) -> torch.Tensor:
        return qmm(attn.reshape(*attn.shape[:2], -1), layer["wo"])

    def attention(self, layer: dict[str, Any], h: torch.Tensor,
                  positions: torch.Tensor, attn_impl: str) -> torch.Tensor:
        """Training's attention block (no KV cache)."""
        q, k, v = self.project(layer, h, positions)
        return self.out(layer, causal_attention(q, k, v, impl=attn_impl))

    def ffn(self, layer: dict[str, Any], h: torch.Tensor) -> torch.Tensor:
        return _ffn_block(layer, self.config, h)

    def router_stats(self, probs: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, int]:
        """(top-1 counts [E], probability sums [E], tokens) of the batch."""
        return _top1_count(probs, self.config.n_experts), probs.sum(dim=0), probs.shape[0]

    def head(self, params: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        return lm_logits(params, x)


def _top1_count(probs: torch.Tensor, n_experts: int) -> torch.Tensor:
    return F.one_hot(probs.argmax(dim=-1), n_experts).float().sum(dim=0)


def check_split(config: LlamaConfig, size: int) -> None:
    """Raise unless the dims Megatron splits divide ``size`` model ranks."""
    hd = config.head_dim
    for what, n in (("vocab", config.vocab_size), ("ffn_hidden", config.ffn_hidden),
                    ("q heads x head_dim", config.n_heads * hd),
                    ("kv heads x head_dim", config.n_kv_heads * hd)):
        if n % size:
            raise ValueError(f"{config.name}: {what} {n} does not split over "
                             f"{size} model ranks")


def serving_layout(config: LlamaConfig, size: int, index: int) -> tuple[bool, int, int]:
    """How rank ``index`` of ``size`` model ranks serves: (whether its KV
    pool holds every KV head, the KV groups of its query heads, the pool
    head the first group reads). Its H / size query heads must be whole
    heads, and over a replicated pool (KV heads that do not split) fill
    whole KV groups or sit inside one; else this raises, naming the model
    and the axis."""
    check_split(config, size)
    H, KV = config.n_heads, config.n_kv_heads
    if H % size:
        raise ValueError(f"{config.name}: {H} query heads do not split over "
                         f"{size} model ranks")
    local, G = H // size, H // KV
    if KV % size == 0:
        return False, KV // size, 0
    if local % G and G % local:
        raise ValueError(f"{config.name}: {local} query heads per rank over a "
                         f"replicated pool of {KV} KV heads ({G} query heads "
                         f"each) at {size} model ranks")
    return True, max(1, local // G), index * local // G


class TensorParallelOps(PlainOps):
    """The blocks on this rank's Megatron shards (the JAX package's
    sharding rules: ``params_logical`` under ``LOGICAL_RULES``), with the
    trainer's collectives (``copy_to``/``reduce_from``/``gather_from``,
    which carry gradients).

    Column-parallel wq/wk/wv/w1/w3 and row-parallel wo/w2 with one
    all-reduce per block; the embedding is split over vocab (each rank
    looks up its rows, one all-reduce) and so is the head (its logits
    all-gathered). A projection whose heads do not divide the axis (KV 2
    at TP 4; one KV head) is cut mid-head by the flat column split, as in
    JAX: it is all-gathered, and each rank takes the heads its slice of wo
    needs. Routed layers run the expert scan with each expert's hidden dim
    split, and the aux loss' token statistics are summed over the
    ``data_group`` of ``n_data`` ranks."""

    def __init__(self, config: LlamaConfig, group, index: int, size: int,
                 data_group=None, n_data: int = 1):
        check_split(config, size)
        super().__init__(config)
        hd = config.head_dim
        self.group, self.index, self.size = group, index, size
        self.data_group, self.n_data = data_group, n_data
        # the flat [H*hd] range of this rank's wo rows, and the heads it spans
        width = config.n_heads * hd // size
        self.rows = (index * width, (index + 1) * width)
        self.heads = (self.rows[0] // hd, -(-self.rows[1] // hd))

    # the crossings between replicated and split tensors (collectives.py)
    def _copy(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(x, self.group)

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from(x, self.group)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return gather_from(x, self.group)

    def _project(self, hf: torch.Tensor, w: Any, b: torch.Tensor | None,
                 n_heads: int) -> tuple[torch.Tensor, int]:
        """[B,S,n_local,hd] and the index of its first head."""
        hd = self.config.head_dim
        y = qmm(hf, w)
        if n_heads % self.size == 0:
            first = self.index * n_heads // self.size
        else:  # cut mid-head: every rank takes the whole projection
            y, first = self._copy(self._gather(y)), 0
        if b is not None:
            y = y + self._copy(b)[first * hd:first * hd + y.shape[-1]]
        return y.reshape(*y.shape[:2], -1, hd), first

    def attention(self, layer: dict[str, Any], h: torch.Tensor,
                  positions: torch.Tensor, attn_impl: str) -> torch.Tensor:
        cfg, hd = self.config, self.config.head_dim
        hf = self._copy(h)
        q, q0 = self._project(hf, layer["wq"], layer.get("bq"), cfg.n_heads)
        k, k0 = self._project(hf, layer["wk"], layer.get("bk"), cfg.n_kv_heads)
        v, _ = self._project(hf, layer["wv"], layer.get("bv"), cfg.n_kv_heads)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        lo, hi = self.heads
        q = q[:, :, lo - q0:hi - q0]
        G = cfg.n_heads // cfg.n_kv_heads
        if cfg.n_heads % self.size or cfg.n_kv_heads % self.size:
            # one kv head per query head, picked from the projection
            pick = torch.tensor([h // G - k0 for h in range(lo, hi)], device=k.device)
            k, v = k.index_select(2, pick), v.index_select(2, pick)
        attn = causal_attention(q, k, v, impl=attn_impl)          # [B,S,hi-lo,hd]
        flat = attn.reshape(*attn.shape[:2], -1)
        flat = flat[..., self.rows[0] - lo * hd:self.rows[1] - lo * hd]
        return self._reduce(flat @ layer["wo"])

    def ffn(self, layer: dict[str, Any], h: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if "router" not in layer:
            hf = self._copy(h)
            gate = activation(hf @ layer["w1"], cfg.hidden_act)
            return self._reduce((gate * (hf @ layer["w3"])) @ layer["w2"])
        B, S, D = h.shape
        flat = h.reshape(-1, D)
        probs = router_probs(layer["router"], flat)
        keep = F.one_hot(top_k_experts(probs, cfg.moe_top_k), cfg.n_experts).float().sum(1)
        gates = probs * keep
        gates = self._copy((gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
                            ).to(h.dtype))
        hf = self._copy(flat)
        acc = torch.zeros_like(flat)
        for e in range(cfg.n_experts):
            hidden = activation(hf @ layer["w1"][e], cfg.hidden_act) * (hf @ layer["w3"][e])
            acc = acc + gates[:, e][:, None] * (hidden @ layer["w2"][e])
        return self._reduce(acc).reshape(B, S, D)

    def embed(self, table: Any, tokens: torch.Tensor) -> torch.Tensor:
        """Each rank looks up the tokens of its vocab rows (zeros for the
        others); the sum over ranks holds one nonzero term, so it is exact."""
        rows = (table["q"] if isinstance(table, dict) else table).shape[0]
        ids = tokens.long() - self.index * rows
        inside = (ids >= 0) & (ids < rows)
        x = embed_rows(table, ids.clamp(0, rows - 1), self.config.embed_multiplier)
        return self._reduce(x * inside[..., None].to(x.dtype))

    def router_stats(self, probs: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, int]:
        count = _top1_count(probs, self.config.n_experts)
        dist.all_reduce(count, group=self.data_group)
        return (count, reduce_from(probs.sum(dim=0), self.data_group),
                probs.shape[0] * self.n_data)

    def head(self, params: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        head = params.get("lm_head")
        head = params["embed"].T if head is None else head
        return self._gather(self._copy(x) @ head).float()


class ServingOps(TensorParallelOps):
    """Serving's Megatron blocks: the plain collectives (no autograd; the
    all-reduces in place), int8 weights, the routed FFN on each expert's
    hidden slice (``_ffn_block``: the grouped kernel or the expert scan),
    and this rank's H / size query heads whole, over its KV pool: its
    KV / size heads when they split, else every KV head, of which its
    query heads read ``kv_groups`` from ``kv_offset`` on. Raises at
    construction when the query heads do not split whole, or a rank's
    query heads over a replicated pool neither fill whole KV groups nor
    sit inside one."""

    def __init__(self, config: LlamaConfig, group, index: int, size: int):
        super().__init__(config, group, index, size)
        self.replicated_kv, self.kv_groups, self.kv_offset = serving_layout(
            config, size, index)

    def _copy(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_(x, self.group)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather_last(x, self.group)

    def project(self, layer: dict[str, Any], h: torch.Tensor, positions: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.config
        q, _ = self._project(h, layer["wq"], layer.get("bq"), cfg.n_heads)
        k, _ = self._project(h, layer["wk"], layer.get("bk"), cfg.n_kv_heads)
        v, _ = self._project(h, layer["wv"], layer.get("bv"), cfg.n_kv_heads)
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta), v)

    def window(self, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if not self.replicated_kv:
            return k, v
        heads = slice(self.kv_offset, self.kv_offset + self.kv_groups)
        return k[:, :, heads].contiguous(), v[:, :, heads].contiguous()

    def prefill_attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor, attn_impl: str, mesh) -> torch.Tensor:
        """Sequence-parallel attention runs on every head, the sequence split
        over the ``model`` axis: the heads are gathered first and this
        rank's taken from the output."""
        if attn_impl not in ("ring", "ulysses"):
            return super().prefill_attention(q, k, v, valid, attn_impl, None)
        B, S, local, hd = q.shape

        def whole(x: torch.Tensor) -> torch.Tensor:
            return self._gather(x.reshape(B, S, -1)).reshape(B, S, -1, hd)

        q_all = whole(q)
        if not self.replicated_kv:
            k, v = whole(k), whole(v)
        out = causal_attention(q_all, k, v, valid, impl=attn_impl, mesh=mesh)
        first = self.index * local
        return out[:, :, first:first + local].contiguous()

    def out(self, layer: dict[str, Any], attn: torch.Tensor) -> torch.Tensor:
        return self._reduce(super().out(layer, attn))

    def ffn(self, layer: dict[str, Any], h: torch.Tensor) -> torch.Tensor:
        return self._reduce(_ffn_block(layer, self.config, h))

    def head(self, params: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        return self._gather(lm_logits(params, x))


# each mesh object's blocks by config, built at its first forward and
# dropped with it. Keyed by identity: a DeviceMesh compares equal to any
# mesh of the same ranks, and an older one's group may be destroyed
_SERVING_OPS: dict[int, tuple[weakref.ref, dict[LlamaConfig, ServingOps]]] = {}


def serving_ops(config: LlamaConfig, mesh=None) -> PlainOps:
    """The forward's blocks: one device's (``mesh`` None), or this rank's
    ``ServingOps`` over ``mesh``'s ``model`` axis, built once per mesh."""
    if mesh is None:
        return PlainOps(config)
    entry = _SERVING_OPS.get(id(mesh))
    if entry is None or entry[0]() is not mesh:
        entry = _SERVING_OPS[id(mesh)] = (weakref.ref(mesh), {})
        weakref.finalize(mesh, _SERVING_OPS.pop, id(mesh), None)
    built = entry[1]
    if config not in built:
        built[config] = ServingOps(config, *axis_group(mesh, "model"))
    return built[config]


def prefill(params: dict[str, Any], config: LlamaConfig, tokens: torch.Tensor,
            positions: torch.Tensor, kv: PagedKVState, slot_ids: torch.Tensor,
            attn_impl: str = "auto", mesh=None,
            last_idx: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, PagedKVState]:
    """Full-sequence forward writing KV into the paged cache.

    tokens/positions: [B, S] (padding has position -1); slot_ids: [B].
    ``attn_impl`` (``ops.attention.causal_attention``): ``auto`` runs the
    flash kernel on CUDA tensors; ``ring``/``ulysses`` the sequence-parallel
    attention over ``mesh``. ``mesh``: this rank's tensor-parallel blocks
    over its ``model`` axis (params and ``kv`` are this rank's shards).
    ``last_idx`` ([B]): only those positions go through the lm head,
    returning [B, vocab] — serving needs one distribution per row, and
    [B, S, vocab] f32 logits would be gigabytes at a 128k vocab.
    Returns (logits [B, S, V] or [B, V] f32, kv)."""
    ops = serving_ops(config, mesh)
    x = ops.embed(params["embed"], tokens)
    mask_valid = positions >= 0
    safe_positions = positions.clamp(min=0)
    for idx, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], config.norm_eps, config.norm_plus_one)
        q, k, v = ops.project(layer, h, safe_positions)
        write_prefill_kv(kv, idx, k, v, slot_ids, safe_positions, mask_valid)
        attn = ops.prefill_attention(q, k, v, mask_valid, attn_impl, mesh)   # [B,S,H,hd]
        x = x + ops.out(layer, attn)
        h = rms_norm(x, layer["ffn_norm"], config.norm_eps, config.norm_plus_one)
        x = x + ops.ffn(layer, h)
    x = rms_norm(x, params["final_norm"], config.norm_eps, config.norm_plus_one)
    if last_idx is not None:
        x = x[torch.arange(x.shape[0], device=x.device), last_idx.long()]
    return ops.head(params, x), kv


def prefill_with_history(params: dict[str, Any], config: LlamaConfig,
                         tokens: torch.Tensor, positions: torch.Tensor,
                         kv: PagedKVState, slot_ids: torch.Tensor,
                         last_idx: torch.Tensor | None = None, mesh=None
                         ) -> tuple[torch.Tensor, PagedKVState]:
    """Suffix prefill attending over cached history (prefix-cache hit).

    tokens/positions: [B, S] with ABSOLUTE positions (a row sharing ``hist``
    cached tokens starts at position ``hist``); padding has position -1.
    The row's block table must already map its history pages. Attention is
    causal by absolute position (cache position c attends iff c <= q_pos),
    so rows with different history lengths share one call. The kernel walks
    only the pages a row uses, so no context-width bucket is needed.
    ``mesh``: as ``prefill``'s.

    On the card the chunk kernel takes all S queries of a layer in one
    call: its scores never reach device memory. The plain path on the CPU
    keeps the JAX package's query tiles of ``_history_tile`` rows, which
    bound its [B, KV, G, T, C] f32 scores.
    Returns (logits [B,S,V] or [B,V] f32, kv)."""
    B, S = tokens.shape
    ops = serving_ops(config, mesh)
    x = ops.embed(params["embed"], tokens)
    mask_valid = positions >= 0
    safe_positions = positions.clamp(min=0)
    KV, hd = ops.kv_groups, config.head_dim
    window = slice(ops.kv_offset, ops.kv_offset + KV)
    on_card = kv.k_pages.is_cuda
    tables = kv.block_tables[slot_ids.long()]
    for idx, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], config.norm_eps, config.norm_plus_one)
        q, k, v = ops.project(layer, h, safe_positions)
        write_prefill_kv(kv, idx, k, v, slot_ids, safe_positions, mask_valid)
        G = q.shape[2] // KV
        if on_card:
            attn = paged_chunk_attention(
                q.reshape(B, S, KV, G, hd), kv.k_pages[idx], kv.v_pages[idx],
                tables, positions.contiguous(), *_layer_scales(kv, idx),
                kv_offset=ops.kv_offset)
        else:
            keys, values = gather_kv(kv, idx, slot_ids)
            keys, values = keys[:, :, window], values[:, :, window]
            tile = _history_tile(S, G)
            attn = torch.cat([
                _history_attention(q[:, t0:t0 + tile], keys, values,
                                   safe_positions[:, t0:t0 + tile],
                                   mask_valid[:, t0:t0 + tile], KV)
                for t0 in range(0, S, tile)], dim=1)
        x = x + ops.out(layer, attn)
        h = rms_norm(x, layer["ffn_norm"], config.norm_eps, config.norm_plus_one)
        x = x + ops.ffn(layer, h)
    x = rms_norm(x, params["final_norm"], config.norm_eps, config.norm_plus_one)
    if last_idx is not None:
        x = x[torch.arange(B, device=x.device), last_idx.long()]
    return ops.head(params, x), kv


def _layer_scales(kv: PagedKVState, idx: int) -> tuple:
    """One layer's page scales for the paged kernels, (k, v) [N, KV] each,
    on an int8 pool; () otherwise."""
    if not kv.quantized:
        return ()
    return kv.k_scales[idx], kv.v_scales[idx]


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
                       valid: torch.Tensor, kv_heads: int
                       ) -> torch.Tensor:
    """Plain chunk attention over the gathered context (history + chunk).

    q: [B,S,H,hd]; keys/values: [B,C,KV,hd] (KV = ``kv_heads``);
    positions/valid: [B,S]. Cache index c attends iff c <= q_position.
    -> [B,S,H,hd]."""
    B, S, H, hd = q.shape
    C = keys.shape[1]
    qg = q.reshape(B, S, kv_heads, H // kv_heads, hd).float()
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
                write_mask: torch.Tensor | None = None, mesh=None
                ) -> tuple[torch.Tensor, PagedKVState]:
    """One decode step over the paged cache.

    tokens/positions: [B] this step's input token and its position;
    slot_ids: [B] block-table rows; seq_lens: [B] tokens in cache including
    this one after its write; write_mask: [B] bool — False rows write to the
    trash page. The kernel reads only each row's ceil(seq_len/page) pages,
    so no context-width bucket is needed. ``mesh``: as ``prefill``'s.
    Returns (logits [B,V] f32, kv)."""
    B = tokens.shape[0]
    ops = serving_ops(config, mesh)
    KV, hd = ops.kv_groups, config.head_dim
    window = slice(ops.kv_offset, ops.kv_offset + KV)
    x = ops.embed(params["embed"], tokens)[:, None, :]
    pos = positions[:, None]
    on_card = kv.k_pages.is_cuda
    tables = kv.block_tables[slot_ids.long()]
    for idx, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], config.norm_eps, config.norm_plus_one)
        q, k, v = ops.project(layer, h, pos)
        write_decode_kv(kv, idx, k[:, 0], v[:, 0], slot_ids, positions,
                        valid=write_mask)
        if on_card:
            attn = paged_decode_attention(
                q[:, 0].reshape(B, KV, -1, hd), kv.k_pages[idx],
                kv.v_pages[idx], tables, seq_lens, *_layer_scales(kv, idx),
                kv_offset=ops.kv_offset)
        else:
            keys, values = gather_kv(kv, idx, slot_ids)
            attn = _paged_decode_attention(q[:, 0], keys[:, :, window],
                                           values[:, :, window], seq_lens, KV)
        x = x + ops.out(layer, attn.reshape(B, 1, -1, hd))
        h = rms_norm(x, layer["ffn_norm"], config.norm_eps, config.norm_plus_one)
        x = x + ops.ffn(layer, h)
    x = rms_norm(x, params["final_norm"], config.norm_eps, config.norm_plus_one)
    return ops.head(params, x[:, 0]), kv


def _paged_decode_attention(q: torch.Tensor, keys: torch.Tensor,
                            values: torch.Tensor, seq_lens: torch.Tensor,
                            kv_heads: int) -> torch.Tensor:
    """Plain decode attention over the gathered context.
    q: [B,H,hd]; keys/values: [B,C,KV,hd] (KV = ``kv_heads``); seq_lens:
    [B] -> [B,1,H,hd]."""
    B, H, hd = q.shape
    C = keys.shape[1]
    qg = q.reshape(B, kv_heads, H // kv_heads, hd).float()
    scores = torch.einsum("bkgh,bckh->bkgc", qg, keys.float()) / math.sqrt(hd)
    valid = torch.arange(C, device=q.device)[None, :] < seq_lens[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgc,bckh->bkgh", probs, values.float())
    return out.reshape(B, 1, H, hd).to(values.dtype)
