"""The port's roofline module against the JAX package's: the same
``roofline_fractions`` and ``CostRegistry`` lookups on the same inputs;
``step_cost`` held to hand counts at llama3-test, and at llama3-8b (B = 8)
its bytes held to the weights and KV bytes counted here from the JAX
model's parameter shapes."""

import math

import jax
import jax.numpy as jnp
import pytest

from mcp_context_forge_tpu.tpu_local import roofline as jax_roofline
from mcp_context_forge_tpu.tpu_local.models import MODEL_CONFIGS as JAX_CONFIGS
from mcp_context_forge_tpu.tpu_local.models.llama import init_params as jax_init_params
from mcp_context_forge_tpu_torch.tpu_local import roofline
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)


@pytest.mark.parametrize("args", [
    (1e12, 1e9, 1.0, 1, 2.0, 2.0),
    (1e12, 1e9, 0.0, 1, 2.0, 2.0),
    (1e12, 1e9, 1.0, 2, 2.0, 2.0),
    (3.7e11, 1.6e10, 0.0113, 1, 989.0, 3350.0),
    (5.0, 7.0, -1.0, 0, 1.0, 1.0),
])
def test_roofline_fractions_equal_jax(args):
    assert roofline.roofline_fractions(*args) == jax_roofline.roofline_fractions(*args)


def test_cost_registry_equals_jax():
    """The same entries give the same exact and width-fallback lookups,
    misses, counts and snapshot; the JAX registry is filled as its capture
    would fill it."""
    entries = {"decode": {(1, 4): (100.0, 200.0), (8, 8): (300.0, 400.0)},
               "spec_verify": {(8, 16): (5.0, 6.0)}}
    ref = jax_roofline.CostRegistry()
    port = roofline.CostRegistry()
    for kind, table in entries.items():
        for (w, c), (f, b) in table.items():
            ref._entries.setdefault(kind, {})[(w, c)] = jax_roofline.CostEntry(f, b)
            assert port.record(kind, w, c, f, b) == roofline.CostEntry(f, b)
    for kind, width, ctx in [("decode", 1, 4), ("decode", 8, 4), ("decode", 2, 8),
                             ("decode", 1, 16), ("prefill", 1, 4),
                             ("spec_verify", 4, 16), ("spec_verify", 8, 8)]:
        want, got = ref.lookup(kind, width, ctx), port.lookup(kind, width, ctx)
        assert (got is None) == (want is None), (kind, width, ctx)
        if want is not None:
            assert (got.flops, got.bytes_accessed) == (want.flops, want.bytes_accessed)
    assert port.counts() == ref.counts()
    assert port.snapshot() == ref.snapshot()


# llama3-test: D 64, 2 layers, 4 q / 2 KV heads of 16, F 128, V 512, untied.
# Weights in f32: per layer attention 64x64 + 2 x 64x32 + 64x64 = 12288
# elements, FFN 3 x 64x128 = 24576, two f32 norms of 64; the final norm, the
# 64x512 head, and B gathered embedding rows. Per token 2 x 2 x 16 = 64 KV
# elements per layer; attention 4 x 4 x 16 = 256 FLOPs per query and key.
WEIGHTS_F32 = 2 * ((12288 + 24576) * 4 + 2 * 64 * 4) + 64 * 4 + 64 * 512 * 4
PARAMS = 2 * (12288 + 24576) + 64 * 512


def test_step_cost_hand_counts_decode():
    """B 4, K 2, two active rows at contexts 5 and 9 (f32 weights and KV)."""
    cost = roofline.step_cost(MODEL_CONFIGS["llama3-test"], "decode", 4, 2, [5, 9],
                              "float32", "float32", compute_dtype="float32")
    per_pass_bytes = WEIGHTS_F32 + 4 * 64 * 4 + 4 * 512 * 4     # + rows, logits
    # iteration 0 reads 5 and 9 keys, iteration 1 reads 6 and 10; one write
    # per row and iteration; 256 B of K and V per token and layer in f32
    kv = 2 * 256 * ((5 + 1) + (9 + 1)) + 2 * 256 * ((6 + 1) + (10 + 1))
    attn = 2 * 256 * (5 + 9) + 2 * 256 * (6 + 10)
    assert cost.flops == 2 * (2 * PARAMS * 4) + attn == 1719296
    assert cost.bytes_accessed == 2 * per_pass_bytes + kv == 890368


def test_step_cost_hand_counts_verify_and_int8_pages():
    cfg = MODEL_CONFIGS["llama3-test"]
    # a verify of K 3 over 4 columns, one row: context 5, chunk width 2
    cost = roofline.step_cost(cfg, "verify", 4, 3, [5], "float32", "float32",
                              compute_dtype="float32", widths=[2])
    assert cost.flops == 2 * PARAMS * 4 * 3 + 2 * 256 * (5 + 6) == 2561536
    assert cost.bytes_accessed == (WEIGHTS_F32 + 4 * 64 * 4 + 4 * 3 * 512 * 4
                                   + 2 * (6 * 256 + 2 * 256)) == 456960
    # int8 pages of 8 tokens: 64 B per token and layer, plus one K and one V
    # f32 scale per page touched and KV head (1 page: 2 x 2 x 4 = 16 B)
    cost = roofline.step_cost(cfg, "decode", 1, 1, [5], "float32", "int8",
                              page_size=8, compute_dtype="float32")
    assert cost.flops == 2 * PARAMS + 2 * 256 * 5 == 215552
    assert cost.bytes_accessed == (WEIGHTS_F32 + 64 * 4 + 512 * 4
                                   + 2 * (5 * 64 + 64 + 16)) == 430368


def test_step_cost_llama3_8b_bytes_against_parameter_shapes():
    """B 8 at K 1 over eight rows of real context: the bytes are within 2 %
    of the bf16 parameter bytes (every leaf of the JAX model's tree, from
    ``jax.eval_shape``, but the embedding table, of which a decode step
    gathers B rows) plus each row's KV bytes."""
    cfg = JAX_CONFIGS["llama3-8b"]
    shapes = jax.eval_shape(lambda key: jax_init_params(cfg, key, jnp.bfloat16),
                            jax.random.PRNGKey(0))
    param_bytes = sum(math.prod(leaf.shape) * leaf.dtype.itemsize
                      for leaf in jax.tree_util.tree_leaves(shapes))
    embed_table = cfg.vocab_size * cfg.dim * 2
    B = 8
    seq_lens = [1500, 470, 473, 27, 44, 35, 900, 2000]
    weights = param_bytes - embed_table + B * cfg.dim * 2
    kv = sum(seq_lens) * cfg.n_layers * 2 * cfg.n_kv_heads * (cfg.dim // cfg.n_heads) * 2
    cost = roofline.step_cost(MODEL_CONFIGS["llama3-8b"], "decode", B, 1, seq_lens)
    assert abs(cost.bytes_accessed - (weights + kv)) <= 0.02 * (weights + kv)
    # FLOPs: 2 x the ~7.5e9 parameters each token multiplies by, x 8 columns
    assert 1.1e11 < cost.flops < 1.3e11
    # a super-step of K 4 reads the weights four times
    cost4 = roofline.step_cost(MODEL_CONFIGS["llama3-8b"], "decode", B, 4, seq_lens)
    assert 3.9 < cost4.bytes_accessed / cost.bytes_accessed < 4.1


def test_step_cost_moe_reads_the_expected_experts():
    """Mixtral at B 1 reads k of E experts per layer; at B 64 nearly all."""
    cfg = MODEL_CONFIGS["mixtral-8x7b"]
    one = roofline.step_cost(cfg, "decode", 1, 1, [10])
    many = roofline.step_cost(cfg, "decode", 64, 1, [10] * 64)
    expert = 3 * cfg.dim * cfg.ffn_hidden * 2 * cfg.n_layers
    assert 5.5 * expert < many.bytes_accessed - one.bytes_accessed < 6.1 * expert
    with pytest.raises(ValueError):
        roofline.step_cost(cfg, "prefill", 1, 1, [10])
