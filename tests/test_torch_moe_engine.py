"""The port's engine serving mixtral-test against the JAX package's, on the
CPU, on the same weights (``params_from_jax``): greedy token streams must be
identical with full-precision and int8 weights, through the expert scan
(``moe_impl="dense"``) and the grouped kernels' path
(``moe_impl="grouped_pallas"``, ``moe_block`` 8 so the 32-token prefill
clears the T*k >= E*block gate; decode steps take the expert scan)."""

import asyncio

import jax
import pytest
import torch

from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.quantize import is_quant
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

SHAPE = dict(model="mixtral-test", max_batch=2, max_seq_len=128, page_size=16,
             num_pages=32, prefill_buckets=(32,), dtype="float32",
             moe_block=8)
PROMPTS = ("route me through experts", "a second, longer prompt here")


async def _streams(engine):
    await engine.start()
    try:
        tok = engine.tokenizer
        jobs = [_collect(engine, tok.encode(p)) for p in PROMPTS]
        return await asyncio.wait_for(asyncio.gather(*jobs), timeout=300)
    finally:
        await engine.stop()


async def _collect(engine, ids):
    return [t async for t in engine.generate(ids, max_tokens=8)]


@pytest.mark.parametrize("quant,ref_impl", [("", "grouped_pallas"),
                                           ("int8", "dense")])
def test_greedy_streams_identical(quant, ref_impl):
    """One JAX engine per weight precision, one on each MoE path (the JAX
    package's own tests hold its dense and grouped_pallas streams equal);
    the port serves the same weights through both of its MoE paths."""
    ref = TPUEngine(JaxConfig(**SHAPE, attn_impl="reference", quant=quant,
                              moe_impl=ref_impl))
    ref_out = asyncio.run(_streams(ref))
    assert all(len(s) == 8 for s in ref_out)
    params = params_from_jax(jax.device_get(ref.params),
                             MODEL_CONFIGS["mixtral-test"], device="cpu",
                             dtype=torch.float32)
    assert is_quant(params["layers"][0]["w1"]) == (quant == "int8")
    for impl in ("dense", "grouped_pallas"):
        port = TorchEngine(EngineConfig(**SHAPE, device="cpu", quant=quant,
                                        moe_impl=impl), params=params)
        assert port.model_config.moe_impl == impl
        assert port.model_config.moe_block == 8
        assert asyncio.run(_streams(port)) == ref_out, impl


def test_random_int8_engine_serves():
    """Random weights with quant="int8" are drawn and quantized by the
    port itself; the engine serves them and a repeat is identical."""
    engine = TorchEngine(EngineConfig(**SHAPE, device="cpu", quant="int8",
                                      moe_impl="grouped_pallas"))
    layer = engine.params["layers"][0]
    assert layer["w1"]["q"].dtype == torch.int8
    assert layer["w1"]["s"].dtype == torch.float32
    assert not is_quant(layer["router"])
    first, again = asyncio.run(_streams(engine)), asyncio.run(_streams(engine))
    assert first == again and all(len(s) == 8 for s in first)


def test_config_refusals():
    with pytest.raises(ValueError, match="quant"):
        TorchEngine(EngineConfig(**SHAPE, device="cpu", quant="int4"))
    with pytest.raises(ValueError, match="moe_impl"):
        TorchEngine(EngineConfig(**SHAPE, device="cpu", moe_impl="grouped_xla"))
