"""The port's speculative verify step against the JAX engine's, on the CPU
in f32: ``_verify_and_sample`` on both engines (``params_from_jax``
weights, fresh pools), its logits at every real position within 1e-5, its
greedy tokens equal, and each position's top-k/top-p mask (its row's
sampling parameters repeated ``spec_k`` times) equal to the mask JAX draws
from."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mcp_context_forge_tpu.tpu_local import engine as jax_engine
from mcp_context_forge_tpu.tpu_local.sampling import \
    SamplingParams as JaxSampling
from mcp_context_forge_tpu_torch.tpu_local import engine as port_engine
from mcp_context_forge_tpu_torch.tpu_local.sampling import (SamplingParams,
                                                            sampling_mask)
from torch_engine_pair import SHAPE, make_pair

K = 4


def test_verify_logits_and_sampling_masks_match_jax(monkeypatch):
    """``_verify_and_sample`` on both engines over the same fresh (zeroed)
    pool: row 0 four tokens at positions 5-8, row 1 three at 0-2 and a
    padding column, rows 2 and 3 padding; row 1 samples."""
    pair = ref, port = make_pair(spec_decode=True, spec_k=K)
    B = SHAPE["max_batch"]
    rng = np.random.default_rng(21)
    tokens = rng.integers(0, 200, (B, K)).astype(np.int32)
    positions = np.full((B, K), -1, dtype=np.int32)
    positions[0] = np.arange(5, 5 + K)
    positions[1, :3] = np.arange(3)
    temperature = np.array([0.0, 0.7, 0.0, 0.0], np.float32)
    top_k = np.array([0, 5, 0, 0], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 1.0], np.float32)
    for engine in pair:
        for slot in range(2):
            assert engine.allocator.allocate_slot(slot, 16)
    captured = {}

    def spy(name, fn):
        def wrapped(logits, params, *args, **kwargs):
            captured[name] = (logits, params)
            return fn(logits, params, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(jax_engine, "sample_tokens",
                        spy("jax", jax_engine.sample_tokens))
    monkeypatch.setattr(port_engine, "sample_tokens",
                        spy("port", port_engine.sample_tokens))
    ref._sync_tables()
    jax_out, _ = ref._verify_and_sample(
        ref.params, ref.kv, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.arange(B, dtype=jnp.int32),
        JaxSampling(jnp.asarray(temperature), jnp.asarray(top_k),
                    jnp.asarray(top_p)), jax.random.PRNGKey(0))
    with torch.inference_mode():
        port._sync_tables()
        out, logits = port._verify_and_sample(
            torch.from_numpy(tokens), torch.from_numpy(positions),
            SamplingParams(torch.from_numpy(temperature),
                           torch.from_numpy(top_k), torch.from_numpy(top_p)),
            torch.arange(B, dtype=torch.int32), any_sampled=True)
    real = (positions >= 0).reshape(-1)
    jax_flat = np.array(captured["jax"][0])
    np.testing.assert_allclose(logits.reshape(B * K, -1).numpy()[real],
                               jax_flat[real], rtol=1e-5, atol=1e-5)
    greedy = np.repeat(temperature == 0.0, K) & real
    np.testing.assert_array_equal(out.reshape(-1).numpy()[greedy],
                                  np.asarray(jax_out).reshape(-1)[greedy])
    jax_params, port_params = captured["jax"][1], captured["port"][1]
    for a, b in zip(jax_params, port_params):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the drawable sets of both packages' masks on JAX's logits
    masked = {}
    categorical = jax.random.categorical

    def grab(key, logits, axis=-1):
        masked["jax"] = np.asarray(logits)
        return categorical(key, logits, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", grab)
    jax_engine.sample_tokens(jnp.asarray(jax_flat), jax_params, jax.random.PRNGKey(1))
    scaled = torch.from_numpy(jax_flat) / port_params.temperature.clamp(min=1e-6)[:, None]
    mask = sampling_mask(scaled, port_params.top_k, port_params.top_p).numpy()
    sampled_rows = np.repeat(temperature > 0, K) & real
    assert sampled_rows.sum() == 3
    np.testing.assert_array_equal(mask[sampled_rows],
                                  np.isfinite(masked["jax"])[sampled_rows])
