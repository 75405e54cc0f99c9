"""The port's model functions against the JAX package's, on the same weights
(carried across by ``params_from_jax``) and the same seeded inputs, in f32
on the CPU. Tolerance: atol = 1e-4 on the logits (both sides compute in
f32; matmul and softmax summation orders differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local.kv import PageAllocator as JaxAllocator
from mcp_context_forge_tpu.tpu_local.kv import init_kv_state as jax_init_kv
from mcp_context_forge_tpu.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu.tpu_local.models import llama as jax_llama
from mcp_context_forge_tpu_torch.tpu_local.kv import init_kv_state
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS as PORT
from mcp_context_forge_tpu_torch.tpu_local.models import llama
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

ATOL = 1e-4
# jitted once per config: eager JAX would compile every op separately
JAX_PREFILL = jax.jit(jax_llama.prefill, static_argnums=(1,),
                      static_argnames=("attn_impl",))
JAX_HISTORY = jax.jit(jax_llama.prefill_with_history, static_argnums=(1,))
JAX_DECODE = jax.jit(jax_llama.decode_step, static_argnums=(1,))
PAGE, NUM_PAGES, SLOTS, PER_SLOT = 8, 32, 2, 6


def _params(name: str):
    """JAX params with random norms and biases (the JAX init leaves them at
    one and zero, which would not exercise (1+w) norms or the bias add)."""
    cfg = MODEL_CONFIGS[name]
    tree = jax.device_get(jax_llama.init_params(cfg, jax.random.PRNGKey(0),
                                                dtype=jnp.float32))
    rng = np.random.default_rng(0)
    for layer in tree["layers"]:
        for key in list(layer):
            if key.endswith("norm") or key.startswith("b"):
                layer[key] = (layer[key] + 0.1 * rng.standard_normal(
                    layer[key].shape)).astype(np.float32)
    tree["final_norm"] = (tree["final_norm"] + 0.1 * rng.standard_normal(
        tree["final_norm"].shape)).astype(np.float32)
    return tree, params_from_jax(tree, PORT[name], device="cpu",
                                 dtype=torch.float32)


def _kv(name: str):
    alloc = JaxAllocator(NUM_PAGES, PAGE, SLOTS, PER_SLOT)
    assert alloc.allocate_slot(0, 40) and alloc.allocate_slot(1, 40)
    tables = np.asarray(alloc.tables())
    jkv = jax_init_kv(MODEL_CONFIGS[name], NUM_PAGES, PAGE, SLOTS, PER_SLOT,
                      dtype=jnp.float32)._replace(block_tables=jnp.asarray(tables))
    pkv = init_kv_state(PORT[name], NUM_PAGES, PAGE, SLOTS, PER_SLOT,
                        dtype=torch.float32, device="cpu")
    pkv.block_tables.copy_(torch.tensor(tables))
    return jkv, pkv


def _close(port: torch.Tensor, ref, **kw):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0, **kw)


@pytest.mark.parametrize("name", ["llama3-test", "qwen2-tiny", "gemma-test",
                                  "mixtral-test"])
def test_model_matches_jax(name):
    """prefill (full logits and last_idx), then prefill_with_history on a
    suffix over the cached prefix, then decode steps — each against the
    JAX function on the same KV state — and the KV pages agree after."""
    cfg = MODEL_CONFIGS[name]
    tree, params = _params(name)
    jkv, pkv = _kv(name)
    rng = np.random.default_rng(1)
    S = 16
    tokens = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    positions = np.stack([np.arange(S), np.arange(S)]).astype(np.int32)
    positions[1, 12:] = -1                          # padded row
    slots = np.array([0, 1], dtype=np.int32)
    T = lambda a: torch.tensor(np.asarray(a))

    jl, jkv = JAX_PREFILL(tree, cfg, tokens, positions, jkv, slots,
                          attn_impl="reference")
    pl_, pkv = llama.prefill(params, PORT[name], T(tokens), T(positions),
                             pkv, T(slots))
    valid = positions >= 0
    _close(pl_[T(valid)], np.asarray(jl)[valid])
    last = np.array([S - 1, 11], dtype=np.int32)
    jl_last, _ = JAX_PREFILL(tree, cfg, tokens, positions, jkv, slots,
                             attn_impl="reference", last_idx=last)
    pl_last, _ = llama.prefill(params, PORT[name], T(tokens), T(positions),
                               pkv, T(slots), last_idx=T(last))
    _close(pl_last, jl_last)

    # suffix prefill over history: row 0 continues at 16, row 1 at 12
    hist_tokens = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    hist_pos = np.stack([np.arange(16, 24), np.arange(12, 20)]).astype(np.int32)
    hist_pos[1, 6:] = -1
    jh, jkv = JAX_HISTORY(tree, cfg, hist_tokens, hist_pos, jkv, slots)
    ph, pkv = llama.prefill_with_history(params, PORT[name], T(hist_tokens),
                                         T(hist_pos), pkv, T(slots))
    hv = hist_pos >= 0
    _close(ph[T(hv)], np.asarray(jh)[hv])

    seq = np.array([24, 18], dtype=np.int32)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2,)).astype(np.int32)
        jd, jkv = JAX_DECODE(tree, cfg, tok, seq, jkv, slots, seq + 1)
        pd, pkv = llama.decode_step(params, PORT[name], T(tok), T(seq), pkv,
                                    T(slots), T(seq + 1))
        _close(pd, jd)
        seq = seq + 1
    for table_pages in np.asarray(jkv.block_tables)[:2]:
        for jp, pp in ((jkv.k_pages, pkv.k_pages), (jkv.v_pages, pkv.v_pages)):
            _close(pp[:, T(table_pages).long()], np.asarray(jp)[:, table_pages])


@pytest.mark.parametrize("name", ["llama3-test", "gemma-test"])
def test_prefill_then_decode_equals_one_long_prefill(name):
    cfg = PORT[name]
    _, params = _params(name)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 20)))
    slot = torch.zeros(1, dtype=torch.int64)

    _, long_kv = _kv(name)
    long_logits, _ = llama.prefill(params, cfg, ids,
                                   torch.arange(20)[None], long_kv, slot)
    _, kv = _kv(name)
    logits, kv = llama.prefill(params, cfg, ids[:, :12],
                               torch.arange(12)[None], kv, slot)
    _close(logits[0, -1], long_logits[0, 11].numpy())
    for p in range(12, 20):
        step, kv = llama.decode_step(params, cfg, ids[:, p],
                                     torch.tensor([p]), kv, slot,
                                     torch.tensor([p + 1]))
        _close(step[0], long_logits[0, p].numpy())
