"""Model configurations (a copy of the JAX package's, so the port imports
nothing of it)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LlamaConfig:
    """Geometry for the GQA+RoPE+SwiGLU decoder family.

    One trunk covers Llama-3, Mistral (v0.3+, no sliding window), Qwen2
    and Gemma. Family knobs: ``attn_bias`` (Qwen2 q/k/v projection
    biases), ``tie_embeddings`` (Qwen2-0.5B, Llama-3.2-1B, Gemma — no
    ``lm_head.weight`` in the HF checkpoint), ``head_dim_override``
    (Gemma decouples head_dim from dim//n_heads: 2B uses 256-wide heads
    on a 2048 model dim), ``hidden_act`` (Gemma gates with tanh-approx
    GeLU instead of SiLU), ``embed_scale`` (Gemma multiplies embeddings
    by sqrt(dim)), and ``norm_plus_one`` (Gemma RMSNorm scales by
    ``1 + weight`` — HF stores the weight zero-centered)."""

    name: str
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    ffn_hidden: int
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    attn_bias: bool = False
    tie_embeddings: bool = False
    head_dim_override: int | None = None
    hidden_act: str = "silu"      # silu | gelu (tanh approximation)
    embed_scale: bool = False     # multiply embeddings by sqrt(dim)
    norm_plus_one: bool = False   # RMSNorm scales by (1 + weight)
    # MoE (Mixtral family): n_experts > 0 replaces the dense FFN with a
    # top-k routed expert FFN. ``moe_impl`` picks the drop-free serving
    # formulation (all compute the same per-token function):
    #   dense          — expert scan with gate masks (E/k x FLOPs waste;
    #                    no gathers — safe default everywhere)
    #   grouped        — block-sparse grouped GEMM, XLA gathered weights
    #                    (~k/E FLOPs; gathers materialize — small models)
    #   grouped_pallas — block-sparse grouped GEMM, Pallas kernel (TPU:
    #                    weight tiles DMA per block via scalar prefetch)
    # parallel/moe.py's capacity dispatch stays the EP-training path.
    # The grouped path only pays when T·k >= E·moe_block (its padded-row
    # bound is T·k + E·moe_block vs dense's E·T): prefill clears the bar,
    # decode (T = batch width) never does — those steps fall back to the
    # dense scan automatically. moe_block is also the kernel's row-block.
    n_experts: int = 0
    moe_top_k: int = 2
    moe_impl: str = "dense"
    moe_block: int = 128

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.dim // self.n_heads

    @property
    def embed_multiplier(self) -> float:
        return float(self.dim) ** 0.5 if self.embed_scale else 1.0


MODEL_CONFIGS: dict[str, LlamaConfig] = {
    # Llama-3-8B geometry (the BASELINE.json flagship)
    "llama3-8b": LlamaConfig(
        name="llama3-8b", vocab_size=128_256, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, ffn_hidden=14_336, rope_theta=500_000.0,
        max_seq_len=8192),
    # ~1B-class for single-chip smoke runs (Llama-3.2-1B geometry; HF ships
    # it with tied embeddings and no lm_head.weight — checkpoints saved
    # before tie_embeddings landed must be re-exported under this name)
    "llama3-1b": LlamaConfig(
        name="llama3-1b", vocab_size=128_256, dim=2048, n_layers=16,
        n_heads=32, n_kv_heads=8, ffn_hidden=8192, max_seq_len=8192,
        tie_embeddings=True),
    # Mistral-7B v0.3 (no sliding window since v0.3)
    "mistral-7b": LlamaConfig(
        name="mistral-7b", vocab_size=32_768, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, ffn_hidden=14_336, rope_theta=1_000_000.0,
        max_seq_len=32_768),
    # Qwen2-7B (QKV biases)
    "qwen2-7b": LlamaConfig(
        name="qwen2-7b", vocab_size=152_064, dim=3584, n_layers=28,
        n_heads=28, n_kv_heads=4, ffn_hidden=18_944, rope_theta=1_000_000.0,
        norm_eps=1e-6, max_seq_len=32_768, attn_bias=True),
    # Mixtral-8x7B: Mistral trunk + 8-expert top-2 MoE FFN
    "mixtral-8x7b": LlamaConfig(
        name="mixtral-8x7b", vocab_size=32_000, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, ffn_hidden=14_336,
        rope_theta=1_000_000.0, max_seq_len=32_768, n_experts=8,
        moe_top_k=2),
    # Gemma-2B: MQA (1 kv head), 256-wide heads decoupled from dim,
    # GeGLU, sqrt(dim)-scaled embeddings, (1+w) RMSNorm, tied head
    "gemma-2b": LlamaConfig(
        name="gemma-2b", vocab_size=256_000, dim=2048, n_layers=18,
        n_heads=8, n_kv_heads=1, ffn_hidden=16_384, rope_theta=10_000.0,
        norm_eps=1e-6, max_seq_len=8192, tie_embeddings=True,
        head_dim_override=256, hidden_act="gelu", embed_scale=True,
        norm_plus_one=True),
    # Qwen2-0.5B (QKV biases + tied embeddings)
    "qwen2-0.5b": LlamaConfig(
        name="qwen2-0.5b", vocab_size=151_936, dim=896, n_layers=24,
        n_heads=14, n_kv_heads=2, ffn_hidden=4864, rope_theta=1_000_000.0,
        norm_eps=1e-6, max_seq_len=32_768, attn_bias=True,
        tie_embeddings=True),
    # tiny Qwen2-style config exercising both family knobs in CI
    "qwen2-tiny": LlamaConfig(
        name="qwen2-tiny", vocab_size=512, dim=256, n_layers=4,
        n_heads=8, n_kv_heads=4, ffn_hidden=688, max_seq_len=2048,
        attn_bias=True, tie_embeddings=True),
    # tiny configs for CI / CPU mesh (byte-level tokenizer vocab)
    "llama3-tiny": LlamaConfig(
        name="llama3-tiny", vocab_size=512, dim=256, n_layers=4,
        n_heads=8, n_kv_heads=4, ffn_hidden=688, max_seq_len=2048),
    "llama3-test": LlamaConfig(
        name="llama3-test", vocab_size=512, dim=64, n_layers=2,
        n_heads=4, n_kv_heads=2, ffn_hidden=128, max_seq_len=512),
    # gemma geometry at CI scale: every family knob exercised (MQA,
    # decoupled 32-wide heads on a 64 model dim, GeGLU, scaled embeds,
    # (1+w) norms, tied head)
    # mixtral geometry at CI scale (4 experts, top-2)
    "mixtral-test": LlamaConfig(
        name="mixtral-test", vocab_size=512, dim=64, n_layers=2,
        n_heads=4, n_kv_heads=2, ffn_hidden=96, max_seq_len=512,
        n_experts=4, moe_top_k=2),
    "gemma-test": LlamaConfig(
        name="gemma-test", vocab_size=512, dim=64, n_layers=2,
        n_heads=4, n_kv_heads=1, ffn_hidden=128, rope_theta=10_000.0,
        norm_eps=1e-6, max_seq_len=512, tie_embeddings=True,
        head_dim_override=32, hidden_act="gelu", embed_scale=True,
        norm_plus_one=True),
}


@dataclass(frozen=True)
class EncoderConfig:
    """Geometry of the bidirectional encoder behind ``embed``/``classify``."""

    name: str
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    ffn_hidden: int
    max_seq_len: int = 512
    n_classes: int = 2  # moderation head: [safe, harmful]
    norm_eps: float = 1e-5


ENCODER_CONFIGS: dict[str, EncoderConfig] = {
    # MiniLM-class geometry
    "encoder-mini": EncoderConfig(
        name="encoder-mini", vocab_size=30_522, dim=384, n_layers=6,
        n_heads=12, ffn_hidden=1536),
    "encoder-tiny": EncoderConfig(
        name="encoder-tiny", vocab_size=512, dim=128, n_layers=2,
        n_heads=4, ffn_hidden=256),
}
