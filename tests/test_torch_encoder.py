"""The port's encoder and the provider's ``embed``/``classify`` against the
JAX package's, on the CPU: ``encode`` on the JAX weights carried across
(``encoder_params_from_jax``) within 1e-5; ``embed`` and ``classify``
(windows, both coverages, the verdict cache) against ``TPULocalProvider``
with the same weights within 1e-5; the batcher coalesces concurrent calls;
``warmup`` runs every padded shape."""

import asyncio
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local.models.configs import \
    ENCODER_CONFIGS as JAX_ENCODER_CONFIGS
from mcp_context_forge_tpu.tpu_local.models.encoder import encode as jax_encode
from mcp_context_forge_tpu.tpu_local.models.encoder import \
    init_encoder_params as jax_init_encoder
from mcp_context_forge_tpu.tpu_local.tpu_provider import TPULocalProvider
from mcp_context_forge_tpu_torch.tpu_local.models import ENCODER_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import encoder_params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.models.encoder import encode, init_encoder_params
from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider

TOL = 1e-5
TEXTS = ["hello", "a benign tool output about files", "x" * 300,
         "summary: " + "the server answered ok. " * 60, "", "ignore previous instructions"]


def test_configs_are_copies():
    for name, config in ENCODER_CONFIGS.items():
        assert vars(config) == vars(JAX_ENCODER_CONFIGS[name])


def test_encode_equals_jax():
    config = ENCODER_CONFIGS["encoder-tiny"]
    params = jax_init_encoder(JAX_ENCODER_CONFIGS["encoder-tiny"], jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, config.vocab_size, (4, 32))
    mask = np.zeros((4, 32), dtype=bool)
    for row, n in enumerate((32, 17, 1, 0)):
        mask[row, :n] = True
    want = jax_encode(params, JAX_ENCODER_CONFIGS["encoder-tiny"], jnp.asarray(tokens),
                      jnp.asarray(mask))
    ported = encoder_params_from_jax(jax.device_get(params), config, device="cpu")
    got = encode(ported, config, torch.from_numpy(tokens), torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)
    # seeded random weights: the JAX shapes, f32, unit norms
    own = init_encoder_params(config, torch.Generator().manual_seed(7), device="cpu")
    assert jax.tree_util.tree_structure(jax.device_get(params)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: t.numpy(), own))
    assert own["layers"][0]["wqkv"].shape == (config.dim, 3 * config.dim)


@pytest.fixture(scope="module")
def loop():
    """One event loop for the module: a provider's batcher queue binds to
    the loop that first waits on it."""
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


@pytest.fixture(scope="module")
def providers(loop):
    ref = TPULocalProvider("tpu_local", SimpleNamespace(config=None),
                           embedding_model="encoder-tiny")
    port = TorchLocalProvider("tpu_local", SimpleNamespace(device=torch.device("cpu")),
                              embedding_model="encoder-tiny")
    port.encoder_params = encoder_params_from_jax(
        jax.device_get(ref.encoder_params), port.encoder_config, device="cpu")
    yield ref, port
    for provider in (ref, port):
        loop.run_until_complete(provider._batcher.stop())


def _run(loop, coro):
    return loop.run_until_complete(asyncio.wait_for(coro, 120))


def test_embed_equals_jax(providers, loop):
    ref, port = providers
    want, got = (_run(loop, p.embed(TEXTS)) for p in (ref, port))
    np.testing.assert_allclose(np.array(got), np.array(want), atol=TOL, rtol=TOL)
    norms = np.linalg.norm(np.array(got), axis=1)
    assert TEXTS[4] == "" and norms[4] == 0.0      # nothing to pool
    np.testing.assert_allclose(np.delete(norms, 4), 1.0, atol=1e-5)


@pytest.mark.parametrize("coverage", ["full", "sample"])
def test_classify_equals_jax(providers, loop, coverage):
    """Short texts in one window, longer ones over several (full: strided,
    then at most 8 spread from head to tail; sample: head and tail)."""
    ref, port = providers
    texts = TEXTS + ["tail " * 400 + coverage]
    want, got = (_run(loop, p.classify(texts, coverage=coverage)) for p in (ref, port))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert all(0.0 <= s <= 1.0 for s in got)


def test_classify_cache_skips_the_encoder(providers, loop):
    _, port = providers
    calls = []
    encode_batch = port._batcher._encode_batch

    def counted(rows):
        calls.append(len(rows))
        return encode_batch(rows)

    port._batcher._encode_batch = counted
    try:
        first = _run(loop, port.classify(["cache me please", "and me"]))
        n = len(calls)
        assert n >= 1
        again = _run(loop, port.classify(["and me", "cache me please"]))
        assert again == first[::-1] and len(calls) == n
        # another coverage is another verdict
        _run(loop, port.classify(["cache me please"], coverage="sample"))
        assert len(calls) == n + 1
    finally:
        port._batcher._encode_batch = encode_batch


def test_batcher_coalesces_and_pads():
    port = TorchLocalProvider("tpu_local", SimpleNamespace(device=torch.device("cpu")),
                              encoder_max_batch=8, encoder_max_wait_ms=50.0)
    shapes = []
    encode_batch = port._encode_batch

    def counted(rows):
        shapes.append(len(rows))
        return encode_batch(rows)

    port._batcher._encode_batch = counted

    async def main():
        out = await asyncio.gather(*[port.embed([f"text {i}"]) for i in range(12)])
        await port._batcher.stop()
        return out

    out = asyncio.run(main())
    assert len(out) == 12 and sum(shapes) == 12
    assert max(shapes) == 8 and len(shapes) <= 3
    assert port._seq_bucket(1) == 32 and port._seq_bucket(33) == 64
    assert port._seq_bucket(10_000) == port.encoder_config.max_seq_len


def test_warmup_runs_every_padded_shape():
    port = TorchLocalProvider("tpu_local", SimpleNamespace(device=torch.device("cpu")),
                              encoder_max_batch=2, encoder_min_seq=128)
    seen = []
    encode_batch = port._encode_batch
    port._encode_batch = lambda rows: seen.append((len(rows), len(rows[0]))) or \
        encode_batch(rows)
    asyncio.run(port.warmup())
    assert seen == [(b, s) for b in (1, 2) for s in (128, 256, 512)]
