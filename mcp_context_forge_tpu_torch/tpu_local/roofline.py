"""Per-dispatch cost counts and the roofline math behind the engine's live
``mfu`` and ``hbm_roofline_frac``.

The JAX engine reads each executable's cost from XLA's
``cost_analysis()`` at warmup. The port has no compiler cost model, so
``step_cost`` counts one decode super-step's or verify's FLOPs and HBM
bytes from the model's shapes and the rows' real context lengths, with
the formulas ``chip_smoke.py`` ``bound()`` uses for each kernel, and the
engine divides them by the step's own wall (retire to retire) at every
decode or verify retire. The peaks default to the H100 SXM data sheet
(dense bf16 tensor cores, HBM3); ``EngineConfig.peak_tflops_per_chip``
and ``hbm_gbps_per_chip`` set others.

Pure Python on purpose: it imports no torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

from .models.configs import LlamaConfig

# NVIDIA H100 SXM, per card, dense (no sparsity)
H100_PEAK_BF16_TFLOPS = 989.0
H100_HBM_GBPS = 3350.0

_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


@dataclass(frozen=True)
class CostEntry:
    """One dispatch's cost: total FLOPs and HBM bytes moved (the whole
    batch, not per row)."""

    flops: float
    bytes_accessed: float


def roofline_fractions(flops: float, bytes_accessed: float, dur_s: float,
                       n_chips: int, peak_tflops_per_chip: float,
                       hbm_gbps_per_chip: float) -> tuple[float, float]:
    """(mfu, hbm_roofline_frac) for one dispatch of known cost and wall."""
    if dur_s <= 0.0:
        return 0.0, 0.0
    chips = max(1, n_chips)
    mfu = flops / dur_s / (peak_tflops_per_chip * 1e12 * chips)
    frac = bytes_accessed / dur_s / (hbm_gbps_per_chip * 1e9 * chips)
    return mfu, frac


class CostRegistry:
    """Per-engine map of (kind, batch width, ctx pages) -> CostEntry: the
    last cost the engine observed for each dispatch family and shape."""

    def __init__(self) -> None:
        self._entries: dict[str, dict[tuple[int, int], CostEntry]] = {}

    def record(self, kind: str, width: int, ctx: int, flops: float,
               bytes_accessed: float) -> CostEntry:
        entry = CostEntry(flops=float(flops), bytes_accessed=float(bytes_accessed))
        self._entries.setdefault(kind, {})[(width, ctx)] = entry
        return entry

    def lookup(self, kind: str, width: int, ctx: int) -> CostEntry | None:
        """Exact (width, ctx) hit, else the same ctx at any width (batch
        rows are cheap next to the shared weight read decode streams)."""
        table = self._entries.get(kind)
        if not table:
            return None
        entry = table.get((width, ctx))
        if entry is not None:
            return entry
        for (_w, c), candidate in sorted(table.items()):
            if c == ctx:
                return candidate
        return None

    def counts(self) -> dict[str, int]:
        return {kind: len(table) for kind, table in sorted(self._entries.items())}

    def snapshot(self) -> dict[str, Any]:
        return {
            kind: {f"{w}x{c}": {"flops": entry.flops,
                                "bytes_accessed": entry.bytes_accessed}
                   for (w, c), entry in sorted(table.items())}
            for kind, table in sorted(self._entries.items())
        }


def _weights(config: LlamaConfig, B: int, weight_dtype: str,
             scale_bytes: int) -> tuple[float, float]:
    """(bytes of the weights one pass over B rows reads, parameters each
    token multiplies by). Every matrix is read once; the embedding table
    only at its B gathered rows (a tied head reads it whole as the head).
    An int8 matrix reads one byte per element plus a scale per output
    channel. MoE layers read the experts that B rows are expected to
    pick, E(1 - (1 - k/E)^B) per layer and pass for uniform top-k
    routing: the routing happens on the device, and the host does not
    see it."""
    D, F, V, L = config.dim, config.ffn_hidden, config.vocab_size, config.n_layers
    hd, H, KV = config.head_dim, config.n_heads, config.n_kv_heads
    q8 = weight_dtype == "int8"
    elem = _BYTES[weight_dtype]

    def matrix(rows: int, cols: int) -> float:
        """Bytes of a [rows, cols] matrix reduced over rows."""
        return rows * cols * elem + (cols * scale_bytes if q8 else 0)

    attn = (matrix(D, H * hd) + 2 * matrix(D, KV * hd) + matrix(H * hd, D))
    attn_params = D * H * hd + 2 * D * KV * hd + H * hd * D
    expert = 2 * matrix(D, F) + matrix(F, D)
    norms = 2 * D * 4                                   # f32 norm weights
    bias = (H + 2 * KV) * hd * (scale_bytes if q8 else elem) if config.attn_bias else 0
    if config.n_experts:
        E, k = config.n_experts, config.moe_top_k
        distinct = E * (1.0 - (1.0 - k / E) ** B)
        ffn = distinct * expert + D * E * (scale_bytes if q8 else elem)   # router
        ffn_params = k * 3 * D * F + D * E
    else:
        ffn = expert
        ffn_params = 3 * D * F
    head = matrix(D, V)
    # the embedding gather: B rows (int8: a scale per row)
    embed_rows = B * (D * elem + (scale_bytes if q8 else 0))
    nbytes = L * (attn + ffn + norms + bias) + D * 4 + head + embed_rows
    params = L * (attn_params + ffn_params) + D * V
    return nbytes, params


def _kv_token_bytes(config: LlamaConfig, kv_dtype: str) -> int:
    """Bytes of one token's K and V in one layer."""
    return 2 * config.n_kv_heads * config.head_dim * _BYTES[kv_dtype]


def _kv_scale_bytes(config: LlamaConfig, tokens: int, page_size: int,
                    scale_bytes: int) -> int:
    """int8 pages: one K and one V scale per (page, KV head) a row's
    ``tokens`` span, in one layer."""
    pages = -(-tokens // page_size)
    return 2 * pages * config.n_kv_heads * scale_bytes


def step_cost(config: LlamaConfig, kind: str, B: int, K: int,
              seq_lens: Sequence[int], weight_dtype: str = "bfloat16",
              kv_dtype: str = "bfloat16", *, page_size: int = 128,
              compute_dtype: str = "bfloat16",
              widths: Sequence[int] | None = None) -> CostEntry:
    """FLOPs and HBM bytes of one dispatch of ``B`` columns.

    ``kind="decode"``: a K-step super-step. ``seq_lens`` holds each active
    row's context at dispatch (its input token included); iteration j
    attends over seq_len + j keys and writes one token of KV.
    ``kind="verify"``: one pass of K tokens per row; ``seq_lens`` holds each
    active row's context up to its first chunk token, and ``widths`` each
    row's real chunk width (K when omitted): query j attends over
    seq_len + j keys.

    Counted, per pass over the weights (K of them in a super-step, one in a
    verify): the dense products, 2 x the parameters each token multiplies
    by x every column (B padded columns, as they run), with attention's
    4 x heads x head_dim FLOPs per query and key; bytes: the weights
    (``_weights``), each active row's KV read once over its real context
    (int8 pages with their scales), its KV writes, and the f32 logits
    written per column."""
    if kind not in ("decode", "verify"):
        raise ValueError(f"step_cost: unknown kind {kind!r}")
    L, H, hd, V = config.n_layers, config.n_heads, config.head_dim, config.vocab_size
    scale_bytes = _BYTES[compute_dtype]
    weight_bytes, params = _weights(config, B, weight_dtype, scale_bytes)
    token_kv = _kv_token_bytes(config, kv_dtype)
    q8_kv = kv_dtype == "int8"
    attn_per_key = 4 * H * hd        # Q.K and P.V, per query and key, per layer
    flops = 0.0
    nbytes = 0.0
    if kind == "decode":
        for j in range(K):
            flops += 2.0 * params * B
            nbytes += weight_bytes + B * V * 4
            for n in seq_lens:
                keys = n + j
                flops += L * attn_per_key * keys
                nbytes += L * (keys * token_kv + token_kv)     # read, write one
                if q8_kv:
                    nbytes += L * _kv_scale_bytes(config, keys, page_size, scale_bytes)
    else:
        widths = list(widths) if widths is not None else [K] * len(seq_lens)
        flops += 2.0 * params * B * K
        nbytes += weight_bytes + B * K * V * 4
        for n, w in zip(seq_lens, widths):
            keys = n + w - 1                                   # the last query's
            flops += L * attn_per_key * sum(n + j for j in range(w))
            nbytes += L * (keys * token_kv + w * token_kv)
            if q8_kv:
                nbytes += L * _kv_scale_bytes(config, keys, page_size, scale_bytes)
    return CostEntry(flops=flops, bytes_accessed=nbytes)
