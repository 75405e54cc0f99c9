"""The port's int8 weight quantization against the JAX package's, on the
CPU and the same seeded inputs: q must be equal exactly and s equal (the
same f32 arithmetic and round-half-to-even); qmm / qmm_t / embed_rows on
quantized leaves within f32 (2e-6) or bf16 (one rounding) of JAX; the
random int8 init equals quantizing the full-precision init; and the
quantized model's logits match JAX's at atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local import quantize as jq
from mcp_context_forge_tpu.tpu_local.kv import init_kv_state as jax_kv
from mcp_context_forge_tpu.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu.tpu_local.models import llama as jax_llama
from mcp_context_forge_tpu_torch.tpu_local import quantize as pq
from mcp_context_forge_tpu_torch.tpu_local.kv import init_kv_state
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS as PORT
from mcp_context_forge_tpu_torch.tpu_local.models import llama
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _assert_leaf_equal(port, ref):
    """A {"q","s"} leaf (or a plain array) equal exactly, dtypes included."""
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _assert_leaf_equal(port[k], ref[k])
        return
    ref = np.asarray(ref)
    assert str(port.dtype).split(".")[-1] == ref.dtype.name
    np.testing.assert_array_equal(port.float().numpy() if port.dtype ==
                                  torch.bfloat16 else port.numpy(), _np(ref))


@pytest.mark.parametrize("shape,axis,dtype", [
    ((48, 40), 0, "float32"),
    ((48, 40), 1, "float32"),
    ((48, 40), 0, "bfloat16"),
    ((3, 32, 24), 1, "bfloat16"),   # an expert stack, per (expert, column)
])
def test_quantize_leaf_matches_jax(shape, axis, dtype):
    jdt, tdt = DTYPES[dtype]
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0                          # an all-zero channel: 1e-8 floor
    w = np.asarray(jnp.asarray(w, jdt))      # the engine quantizes its dtype
    ref = jax.device_get(jq.quantize_leaf(w, axis, scale_dtype=jdt))
    out = pq.quantize_leaf(torch.tensor(_np(w)).to(tdt), axis, tdt)
    assert out["q"].dtype == torch.int8 and out["s"].dtype == tdt
    _assert_leaf_equal(out, ref)


@pytest.mark.parametrize("name,dtype", [("mixtral-test", "float32"),
                                        ("mixtral-test", "bfloat16"),
                                        ("gemma-test", "float32")])
def test_quantize_tree_matches_jax(name, dtype):
    """Every leaf of a quantized tree (tied and untied heads, MoE stacks,
    router and norms left alone), plus the logical map and the bytes."""
    jdt, tdt = DTYPES[dtype]
    cfg = MODEL_CONFIGS[name]
    tree = jax.device_get(jax_llama.init_params(cfg, jax.random.PRNGKey(0),
                                                dtype=jdt))
    logical = jax_llama.params_logical(cfg)
    ref = jax.device_get(jq.quantize_tree(tree, logical, scale_dtype=jdt))
    params = params_from_jax(tree, PORT[name], device="cpu", dtype=tdt)
    assert llama.params_logical(PORT[name]) == logical
    assert pq.quantize_logical(logical) == jq.quantize_logical(logical)
    out = pq.quantize_tree(params, llama.params_logical(PORT[name]), tdt)
    _assert_leaf_equal(out["embed"], ref["embed"])
    for port_layer, ref_layer in zip(out["layers"], ref["layers"]):
        assert set(port_layer) == set(ref_layer)
        for key in ref_layer:
            _assert_leaf_equal(port_layer[key], ref_layer[key])
    assert pq.param_bytes(out) == jq.param_bytes(ref)
    assert llama.param_count(PORT[name]) == jax_llama.param_count(cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qmm_qmm_t_embed_rows_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    w = np.asarray(jnp.asarray(rng.standard_normal((32, 48)), jdt))
    table = np.asarray(jnp.asarray(rng.standard_normal((64, 32)), jdt))
    x = np.asarray(jnp.asarray(rng.standard_normal((5, 32)), jdt))
    tokens = rng.integers(0, 64, (2, 7)).astype(np.int32)
    jw = jq.quantize_leaf(w, 0, scale_dtype=jdt)
    jt = jq.quantize_leaf(table, 1, scale_dtype=jdt)
    pw = pq.quantize_leaf(torch.tensor(_np(w)).to(tdt), 0, tdt)
    pt = pq.quantize_leaf(torch.tensor(_np(table)).to(tdt), 1, tdt)
    tx = torch.tensor(_np(x)).to(tdt)
    tol = dict(rtol=2e-6, atol=2e-6) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)
    for port, ref in (
            (pq.qmm(tx, pw), jq.qmm(jnp.asarray(x), jw)),
            (pq.qmm_t(tx, pt), jq.qmm_t(jnp.asarray(x), jt)),
            (pq.embed_rows(pt, torch.from_numpy(tokens), 2.0),
             jq.embed_rows(jt, jnp.asarray(tokens), 2.0))):
        assert port.dtype == tdt
        np.testing.assert_allclose(port.float().numpy(), _np(ref), **tol)
    # plain leaves pass straight through
    assert torch.equal(pq.qmm(tx, torch.tensor(_np(w)).to(tdt)),
                       tx @ torch.tensor(_np(w)).to(tdt))


def test_params_from_jax_carries_quantized_leaves():
    """q stays int8 and s keeps its (bf16) dtype whatever ``dtype`` the
    full-precision leaves take; router and stacks cross as they are."""
    cfg = MODEL_CONFIGS["mixtral-test"]
    tree = jax_llama.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    ref = jax.device_get(jq.quantize_tree(tree, jax_llama.params_logical(cfg),
                                          scale_dtype=jnp.bfloat16))
    params = params_from_jax(ref, PORT["mixtral-test"], device="cpu",
                             dtype=torch.float32)
    layer = params["layers"][0]
    assert layer["w1"]["q"].dtype == torch.int8
    assert layer["w1"]["q"].shape == (4, 64, 96)
    assert layer["w1"]["s"].dtype == torch.bfloat16
    assert layer["w2"]["s"].shape == (4, 64)
    assert layer["router"].dtype == torch.float32
    assert layer["attn_norm"].dtype == torch.float32
    for key in ("w1", "w3", "w2", "wq", "wo"):
        _assert_leaf_equal(layer[key], ref["layers"][0][key])
    _assert_leaf_equal(params["lm_head"], ref["lm_head"])


@pytest.mark.parametrize("name", ["mixtral-test", "qwen2-tiny"])
def test_init_params_int8_equals_quantized_init(name):
    """The port draws and quantizes one leaf (one expert) at a time; the
    result equals quantizing the full-precision draw of the same seed."""
    cfg = PORT[name]
    full = llama.init_params(cfg, torch.Generator().manual_seed(3),
                             torch.bfloat16, "cpu")
    want = pq.quantize_tree(full, llama.params_logical(cfg), torch.bfloat16)
    got = llama.init_params(cfg, torch.Generator().manual_seed(3),
                            torch.bfloat16, "cpu", quant="int8")

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b, strict=True):
                same(x, y)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)

    same(got, want)
    assert pq.param_bytes(got) < pq.param_bytes(full) * 0.6
    with pytest.raises(ValueError, match="quant"):
        llama.init_params(cfg, torch.Generator(), torch.float32, "cpu",
                          quant="int4")


JAX_PREFILL = jax.jit(jax_llama.prefill, static_argnums=(1,),
                      static_argnames=("attn_impl",))
JAX_DECODE = jax.jit(jax_llama.decode_step, static_argnums=(1,))


@pytest.mark.parametrize("name", ["llama3-test", "mixtral-test"])
def test_int8_model_matches_jax(name):
    """An int8 tree (f32 scales) through prefill and two decode steps (the
    MoE expert scan on int8 stacks): logits at atol 1e-4."""
    cfg = MODEL_CONFIGS[name]
    tree = jax_llama.init_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    tree = jax.device_get(jq.quantize_tree(tree, jax_llama.params_logical(cfg)))
    params = params_from_jax(tree, PORT[name], device="cpu",
                             dtype=torch.float32)
    tables = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    jkv = jax_kv(cfg, 16, 8, 2, 4, dtype=jnp.float32)._replace(
        block_tables=jnp.asarray(tables))
    pkv = init_kv_state(PORT[name], 16, 8, 2, 4, dtype=torch.float32,
                        device="cpu")
    pkv.block_tables.copy_(torch.from_numpy(tables))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    positions = np.stack([np.arange(12)] * 2).astype(np.int32)
    slots = np.array([0, 1], np.int32)
    ref, jkv = JAX_PREFILL(tree, cfg, tokens, positions, jkv, slots,
                           attn_impl="reference")
    out, pkv = llama.prefill(params, PORT[name], torch.from_numpy(tokens),
                             torch.from_numpy(positions), pkv,
                             torch.from_numpy(slots))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    seq = np.array([12, 12], np.int32)
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab_size, (2,)).astype(np.int32)
        ref, jkv = JAX_DECODE(tree, cfg, tok, seq, jkv, slots, seq + 1)
        out, pkv = llama.decode_step(params, PORT[name], torch.from_numpy(tok),
                                     torch.from_numpy(seq), pkv,
                                     torch.from_numpy(slots),
                                     torch.from_numpy(seq + 1))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-4)
        seq = seq + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
def test_embed_multiplier_scalar_equals_tensor_multiply(dtype, quant):
    """Gemma's embedding multiplier is rounded to the rows' dtype once and
    applied as a Python scalar (no host-to-device copy): the same bits as
    the product by a 0-d tensor of that dtype, plain and int8 tables."""
    rng = np.random.default_rng(8)
    table = torch.from_numpy(rng.standard_normal((50, 24)).astype(np.float32)).to(dtype)
    if quant:
        table = pq.quantize_leaf(table, 1, dtype)
    tokens = torch.from_numpy(rng.integers(0, 50, (3, 7)))
    multiplier = 24 ** 0.5
    rows = pq.embed_rows(table, tokens)
    want = rows * torch.tensor(multiplier, dtype=rows.dtype)
    got = pq.embed_rows(table, tokens, multiplier)
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
