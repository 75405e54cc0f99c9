"""The port over a trained checkpoint: the tiny HF checkpoint that
``mcp_context_forge_tpu.tools.tiny_checkpoint`` trains (a real BPE
``tokenizer.json``; llama3-test weights that memorised a small corpus)
goes through the port's ``load_tokenizer`` and a ``TorchEngine`` on the
CPU. Greedy completions carry the memorised facts, and their token ids
equal a ``TPUEngine``'s on the same directory, in f32 and in int8."""

import asyncio
import os

import pytest

from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.tokenizer import HFTokenizer, load_tokenizer

SHAPE = dict(model="llama3-test", max_batch=2, max_seq_len=64, page_size=16,
             num_pages=64, prefill_buckets=(16, 32), dtype="float32")
PROMPTS = ("the capital of france is", "the capital of japan is")


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    prebuilt = os.environ.get("MCPFORGE_TINY_CKPT")
    if prebuilt:
        if not os.path.isdir(prebuilt):
            pytest.skip(f"MCPFORGE_TINY_CKPT={prebuilt} does not exist")
        return prebuilt
    from mcp_context_forge_tpu.tools.tiny_checkpoint import build

    out = str(tmp_path_factory.mktemp("tiny-ckpt"))
    loss = build(out, steps=400)
    assert loss < 0.5, f"memorization failed (loss {loss:.3f})"
    return out


def complete(engine, prompts=PROMPTS, max_tokens: int = 12) -> list[list[int]]:
    """Greedy token ids of each prompt, one request at a time."""
    async def main():
        await engine.start()
        try:
            outs = []
            for prompt in prompts:
                ids = engine.tokenizer.encode(prompt)
                outs.append([t async for t in engine.generate(ids, max_tokens=max_tokens)])
            return outs
        finally:
            await engine.stop()

    return asyncio.run(main())


def test_real_tokenizer_loads(checkpoint_dir):
    tok = load_tokenizer(checkpoint_dir)
    assert isinstance(tok, HFTokenizer)  # not the byte fallback
    ids = tok.encode("the capital of france", add_bos=False)
    assert 0 < len(ids) < len("the capital of france")  # real BPE merges
    assert tok.decode(ids) == "the capital of france"
    assert tok.encode("x")[0] == tok.bos_id == tok._tok.token_to_id("<|begin_of_text|>")


@pytest.mark.parametrize("quant", ("", "int8"))
def test_completions_equal_tpu_engine(checkpoint_dir, quant):
    port = TorchEngine(EngineConfig(**SHAPE, checkpoint=checkpoint_dir, quant=quant,
                                    device="cpu"))
    assert isinstance(port.tokenizer, HFTokenizer)
    got = complete(port)
    ref = TPUEngine(JaxConfig(**SHAPE, checkpoint=checkpoint_dir, quant=quant,
                              attn_impl="reference"))
    assert got == complete(ref)
    texts = [port.tokenizer.decode(ids) for ids in got]
    assert "paris" in texts[0] and "tokyo" in texts[1], texts
