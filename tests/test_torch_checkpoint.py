"""The port's checkpoint loading (``tpu_local/checkpoint.py``) against the
JAX package's, on the CPU: HF safetensors directories written with
``safetensors.numpy.save_file`` across two shards load into the same leaves
as the JAX ``load_params`` gives, for every config family; the port's own
reader against the real format (BF16 kept as bf16); int8 on the way in
equal to ``quantize_tree`` bit for bit, expert stacks included (where the
JAX loader's expert scales differ); the port's own save/restore; the load
errors; and a ``TorchEngine`` booted from a checkpoint against a
``TPUEngine`` booted from the same one."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local import checkpoint as jax_checkpoint
from mcp_context_forge_tpu.tpu_local.models import MODEL_CONFIGS as JAX_CONFIGS
from mcp_context_forge_tpu.tpu_local.models.llama import init_params as jax_init_params
from mcp_context_forge_tpu.tpu_local.models.llama import params_logical as jax_logical
from mcp_context_forge_tpu.tpu_local.parallel import make_mesh, param_specs
from mcp_context_forge_tpu.tpu_local.quantize import quantize_logical as jax_quant_logical
from mcp_context_forge_tpu_torch.tpu_local import checkpoint
from mcp_context_forge_tpu_torch.tpu_local.checkpoint import (PARAMS_FILE, Staging,
                                                              expected_tree,
                                                              load_hf_llama,
                                                              load_params,
                                                              read_safetensors,
                                                              save_params)
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.models.llama import init_params, params_logical
from mcp_context_forge_tpu_torch.tpu_local.quantize import quantize_tree

from torch_engine_pair import SHAPE, TEXTS, serve
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

FAMILIES = ("llama3-test", "qwen2-tiny", "gemma-test", "mixtral-test")


def draw_tree(model: str, seed: int) -> dict:
    """A JAX-initialised f32 tree (numpy) whose norms and biases are random
    too, so that a leaf loaded into the wrong place cannot pass."""
    tree = jax.device_get(jax_init_params(JAX_CONFIGS[model],
                                          jax.random.PRNGKey(seed),
                                          dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    tree["final_norm"] = rng.standard_normal(tree["final_norm"].shape, np.float32)
    for layer in tree["layers"]:
        for name in ("attn_norm", "ffn_norm", "bq", "bk", "bv"):
            if name in layer:
                layer[name] = rng.standard_normal(layer[name].shape, np.float32)
    return tree


def hf_tensors(tree: dict) -> dict[str, np.ndarray]:
    """The tree under HF names and layouts (transposed ``*.weight``
    matrices, per-expert Mixtral tensors)."""
    def t(x):
        return np.ascontiguousarray(np.asarray(x).T)

    out = {"model.embed_tokens.weight": np.asarray(tree["embed"]),
           "model.norm.weight": np.asarray(tree["final_norm"])}
    if "lm_head" in tree:
        out["lm_head.weight"] = t(tree["lm_head"])
    for i, layer in enumerate(tree["layers"]):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = np.asarray(layer["attn_norm"])
        out[p + "post_attention_layernorm.weight"] = np.asarray(layer["ffn_norm"])
        for name, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                         ("wo", "o_proj")):
            out[p + f"self_attn.{hf}.weight"] = t(layer[name])
        for name, hf in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            if name in layer:
                out[p + f"self_attn.{hf}.bias"] = np.asarray(layer[name])
        if "router" in layer:
            out[p + "block_sparse_moe.gate.weight"] = t(layer["router"])
            for m in range(layer["w1"].shape[0]):
                for name in ("w1", "w2", "w3"):
                    out[p + f"block_sparse_moe.experts.{m}.{name}.weight"] = \
                        t(layer[name][m])
        else:
            for name, hf in (("w1", "gate_proj"), ("w3", "up_proj"),
                             ("w2", "down_proj")):
                out[p + f"mlp.{hf}.weight"] = t(layer[name])
    return out


def write_hf(path: str, tensors: dict[str, np.ndarray]) -> str:
    """Two shards, as HF splits large checkpoints."""
    from safetensors.numpy import save_file

    keys = sorted(tensors)
    half = len(keys) // 2
    os.makedirs(path, exist_ok=True)
    save_file({k: tensors[k] for k in keys[:half]},
              os.path.join(path, "model-00001-of-00002.safetensors"))
    save_file({k: tensors[k] for k in keys[half:]},
              os.path.join(path, "model-00002-of-00002.safetensors"))
    return path


def jax_load(path: str, model: str, quant: str = "") -> dict:
    config = JAX_CONFIGS[model]
    with make_mesh(""):
        logical = jax_logical(config)
        if quant:
            logical = jax_quant_logical(logical)
        shardings = param_specs(logical, make_mesh(""))
        return jax.device_get(jax_checkpoint.load_params(
            path, config, shardings, jnp.float32, quant=quant))


def pairs(port: dict, other: dict, prefix=()):
    """(path, port leaf, other leaf) over the port's tree."""
    if isinstance(port, dict):
        assert set(port) == set(other), prefix
        for key in port:
            yield from pairs(port[key], other[key], prefix + (key,))
    elif isinstance(port, list):
        assert len(port) == len(other), prefix
        for i, (a, b) in enumerate(zip(port, other)):
            yield from pairs(a, b, prefix + (i,))
    else:
        yield prefix, port, other


def assert_bit_equal(port: dict, other: dict) -> None:
    for path, a, b in pairs(port, other):
        if not isinstance(b, torch.Tensor):
            b = torch.from_numpy(np.asarray(b))
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


@pytest.mark.parametrize("model", FAMILIES)
def test_hf_roundtrip_equals_jax(model, tmp_path):
    tree = draw_tree(model, seed=3)
    path = write_hf(str(tmp_path / "hf"), hf_tensors(tree))
    config = MODEL_CONFIGS[model]
    got = load_params(path, config, device="cpu", dtype=torch.float32)
    want = params_from_jax(jax_load(path, model), config, device="cpu",
                           dtype=torch.float32)
    assert_bit_equal(got, want)
    # and the drawn tree itself
    assert_bit_equal(got, params_from_jax(tree, config, device="cpu",
                                          dtype=torch.float32))
    if config.tie_embeddings:
        assert "lm_head" not in got


@pytest.mark.parametrize("staged", [False, True])
def test_bf16_file_read_as_bf16(tmp_path, staged):
    """A BF16 tensor is read as bf16 bits, equal to the JAX reader's f32
    widening cast back; F32 and I64 pass unchanged; read through one
    reused staging buffer (as onto a card, unpinned here) each tensor is
    right until the next is read."""
    from safetensors.torch import save_file

    gen = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn(33, 17, generator=gen).to(torch.bfloat16),
               "f": torch.randn(5, generator=gen),
               "i": torch.arange(7, dtype=torch.int64),
               "e": torch.zeros(0, 4)}
    path = str(tmp_path / "one.safetensors")
    save_file(tensors, path)
    staging = Staging(pin=False) if staged else None
    got = {name: t.clone() for name, t in read_safetensors(path, staging)}
    ref = jax_checkpoint._read_safetensors(path)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], torch.from_numpy(ref["w"]).to(torch.bfloat16))
    assert torch.equal(got["w"].float(), torch.from_numpy(ref["w"]))
    for name in ("w", "f", "i", "e"):
        assert got[name].dtype == tensors[name].dtype
        assert torch.equal(got[name], tensors[name]), name


def test_bf16_load_keeps_norms_f32(tmp_path):
    """Loaded into a bf16 engine, norm weights stay f32 (as
    ``params_from_jax`` keeps them) and every other leaf is the file's
    values rounded once to bf16. The JAX loader casts its norms to bf16."""
    model = "gemma-test"
    tree = draw_tree(model, seed=4)
    path = write_hf(str(tmp_path / "hf"), hf_tensors(tree))
    config = MODEL_CONFIGS[model]
    got = load_params(path, config, device="cpu", dtype=torch.bfloat16)
    assert_bit_equal(got, params_from_jax(tree, config, device="cpu",
                                          dtype=torch.bfloat16))
    assert got["layers"][0]["attn_norm"].dtype == torch.float32
    with make_mesh(""):
        shardings = param_specs(jax_logical(JAX_CONFIGS[model]), make_mesh(""))
        ref = jax_checkpoint.load_params(path, JAX_CONFIGS[model], shardings,
                                         jnp.bfloat16)
    assert ref["layers"][0]["attn_norm"].dtype == jnp.bfloat16


@pytest.mark.parametrize("model,block", [("llama3-test", None), ("mixtral-test", None),
                                         ("llama3-test", 1000), ("mixtral-test", 1000)])
def test_int8_on_the_way_in_equals_quantize_tree(model, block, tmp_path, monkeypatch):
    """Also with the quantization cut into blocks of a few slices (the
    embedding, the head and the expert matrices take several)."""
    if block is not None:
        monkeypatch.setattr(checkpoint, "QUANT_BLOCK", block)
    tree = draw_tree(model, seed=5)
    path = write_hf(str(tmp_path / "hf"), hf_tensors(tree))
    config = MODEL_CONFIGS[model]
    got = load_params(path, config, device="cpu", dtype=torch.float32,
                      quant="int8")
    full = params_from_jax(tree, config, device="cpu", dtype=torch.float32)
    assert_bit_equal(got, quantize_tree(full, params_logical(config),
                                        scale_dtype=torch.float32))
    if config.n_experts:
        E, D, F = config.n_experts, config.dim, config.ffn_hidden
        layer = got["layers"][0]
        assert layer["w1"]["s"].shape == layer["w3"]["s"].shape == (E, F)
        assert layer["w2"]["s"].shape == (E, D)


def test_jax_loader_expert_scales_reduce_the_expert_axis(tmp_path):
    """The known difference: the JAX loader quantizes expert stacks over
    axis 0, the expert axis, so its scales are [D, F] / [F, D], where
    ``quantize_tree`` (and the port's loader) give [E, F] / [E, D]."""
    model = "mixtral-test"
    path = write_hf(str(tmp_path / "hf"), hf_tensors(draw_tree(model, seed=5)))
    ref = jax_load(path, model, quant="int8")
    config = JAX_CONFIGS[model]
    assert ref["layers"][0]["w1"]["s"].shape == (config.dim, config.ffn_hidden)
    assert ref["layers"][0]["w2"]["s"].shape == (config.ffn_hidden, config.dim)
    dense = jax_load(path, model)   # the dense leaves are the same in both
    assert np.array_equal(ref["layers"][0]["attn_norm"], dense["layers"][0]["attn_norm"])


@pytest.mark.parametrize("quant", ("", "int8"))
@pytest.mark.parametrize("model", FAMILIES)
def test_expected_tree_is_init_params(model, quant):
    """The own format's expected tree, from the geometry alone, is the
    tree ``init_params`` builds: keys, shapes and dtypes."""
    config = MODEL_CONFIGS[model]
    want = init_params(config, None, torch.bfloat16, "meta", quant=quant)
    got = expected_tree(config, torch.bfloat16, quant)
    for path, a, b in pairs(got, want):
        assert (a.shape, a.dtype, a.device.type) == (b.shape, b.dtype, "meta"), path


@pytest.mark.parametrize("quant", ("", "int8"))
def test_own_format_roundtrip(quant, tmp_path):
    model = "mixtral-test"
    config = MODEL_CONFIGS[model]
    hf = write_hf(str(tmp_path / "hf"), hf_tensors(draw_tree(model, seed=6)))
    params = load_params(hf, config, device="cpu", dtype=torch.float32, quant=quant)
    own = str(tmp_path / "own")
    save_params(own, params)
    assert os.listdir(own) == [PARAMS_FILE]
    assert_bit_equal(load_params(own, config, device="cpu",
                                 dtype=torch.float32, quant=quant), params)


def test_own_format_refuses_a_tree_of_another_kind(tmp_path):
    config = MODEL_CONFIGS["llama3-test"]
    hf = write_hf(str(tmp_path / "hf"), hf_tensors(draw_tree("llama3-test", 7)))
    own = str(tmp_path / "own")
    save_params(own, load_params(hf, config, device="cpu", dtype=torch.float32))
    with pytest.raises(ValueError, match=r"does not match the quantized \(int8\)"):
        load_params(own, config, device="cpu", dtype=torch.float32, quant="int8")
    with pytest.raises(ValueError, match="does not match the tree of qwen2-tiny"):
        load_params(own, MODEL_CONFIGS["qwen2-tiny"], device="cpu")
    with pytest.raises(FileNotFoundError):
        load_params(str(tmp_path), config, device="cpu")


@pytest.mark.parametrize("model,drop,message", [
    ("llama3-test", "model.layers.1.self_attn.o_proj.weight",
     "Checkpoint missing tensors for"),
    ("qwen2-tiny", "model.layers.0.self_attn.k_proj.bias",
     "Checkpoint missing tensors for"),
    ("mixtral-test", "model.layers.1.block_sparse_moe.experts.2.w3.weight",
     "Checkpoint has incomplete expert stacks for"),
])
def test_load_errors_match_jax(model, drop, message, tmp_path):
    tensors = hf_tensors(draw_tree(model, seed=8))
    del tensors[drop]
    path = write_hf(str(tmp_path / "hf"), tensors)
    with pytest.raises(ValueError, match=message) as port_exc:
        load_hf_llama(path, MODEL_CONFIGS[model], device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match=message) as jax_exc:
        jax_load(path, model)
    assert str(port_exc.value) == str(jax_exc.value)


@pytest.mark.parametrize("quant", ("", "int8"))
def test_engine_from_checkpoint_equals_tpu_engine(quant, tmp_path):
    """Greedy streams of a TorchEngine and a TPUEngine booted from the same
    HF checkpoint (llama3-test, f32), full precision and int8; the port's
    own saved tree serves the same streams."""
    from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
    from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
    from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine

    path = write_hf(str(tmp_path / "hf"), hf_tensors(draw_tree("llama3-test", 9)))
    ref = TPUEngine(JaxConfig(**SHAPE, checkpoint=path, quant=quant,
                              attn_impl="reference"))
    port = TorchEngine(EngineConfig(**SHAPE, checkpoint=path, quant=quant,
                                    device="cpu"))
    jobs = [(port.tokenizer.encode(text), dict(max_tokens=8)) for text in TEXTS]
    want = serve(ref, jobs)
    assert serve(port, jobs) == want
    own = str(tmp_path / "own")
    save_params(own, port.params)
    again = TorchEngine(EngineConfig(**SHAPE, checkpoint=own, quant=quant,
                                     device="cpu"))
    assert serve(again, jobs) == want
    with pytest.raises(ValueError, match="not both"):
        TorchEngine(EngineConfig(**SHAPE, checkpoint=own, device="cpu"),
                    params=port.params)
