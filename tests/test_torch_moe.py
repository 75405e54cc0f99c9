"""The port's MoE FFN against the JAX package's, on the CPU: the routing
plan, the plain versions of the two grouped-expert kernels against the
Pallas kernels in interpret mode, the expert scan and the grouped FFN, the
``_ffn_block`` gate, and a Mixtral model forward through both paths.

Tolerances: routing integers exact and gates within 1e-6 (same f32 math);
f32 FFN outputs rtol 1e-4 / atol 1e-5 against the Pallas kernels (their F
tiles sum in another order) and rtol 2e-5 / atol 2e-6 against the JAX
formulations (one f32 matmul order apart); bf16 kernel outputs 2e-2 (one
bf16 rounding of the output, plus the order of f32 sums).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu.tpu_local.models import llama as jax_llama
from mcp_context_forge_tpu.tpu_local.ops import grouped_moe as jax_gm
from mcp_context_forge_tpu.tpu_local.parallel import moe as jax_moe
from mcp_context_forge_tpu.tpu_local.quantize import quantize_tree as jax_qtree
from mcp_context_forge_tpu_torch.tpu_local.kv import init_kv_state
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS as PORT
from mcp_context_forge_tpu_torch.tpu_local.models import llama
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.ops import grouped_moe as gm
from mcp_context_forge_tpu_torch.tpu_local.parallel import moe
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

CFG = jax_moe.MoEConfig(dim=32, n_experts=8, expert_hidden=64, top_k=2)
PCFG = moe.MoEConfig(dim=32, n_experts=8, expert_hidden=64, top_k=2)
LOGICAL = {"router": "replicated", "w1": "moe_up", "w3": "moe_up",
           "w2": "moe_down"}
F32 = dict(rtol=2e-5, atol=2e-6)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32)
                        if np.asarray(a).dtype.name == "bfloat16"
                        else np.asarray(a))


def _tree(tree):
    """JAX MoE params (numpy) -> port tensors; {"q","s"} leaves kept."""
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return _t(tree)


def _params(quant=False, seed=0):
    params = jax_moe.init_moe_params(CFG, jax.random.PRNGKey(seed))
    if quant:
        params = jax_qtree(dict(params), LOGICAL)
    return params, _tree(jax.device_get(params))


def _x(shape=(2, 24), seed=1):
    return np.random.default_rng(seed).standard_normal(
        (*shape, CFG.dim)).astype(np.float32)


def _skew_router():
    """Every token routes to expert 3 first; the second slot is an exact
    tie among the other seven (jax.lax.top_k takes the lowest index)."""
    router = np.zeros((CFG.dim, CFG.n_experts), np.float32)
    router[:, 3] = 1.0
    return router


# ---------------------------------------------------------------- routing

@pytest.mark.parametrize("case", ["random", "skew"])
def test_route_plan_matches_jax(case):
    rng = np.random.default_rng(3)
    if case == "random":
        logits = rng.standard_normal((50, CFG.n_experts)).astype(np.float32)
    else:
        x = np.abs(rng.standard_normal((40, CFG.dim))).astype(np.float32) + 0.1
        logits = x @ _skew_router()
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    ref = jax_gm.route_sorted_blocks(jnp.asarray(probs), CFG.top_k, 16)
    plan = gm.route_sorted_blocks(torch.from_numpy(probs), CFG.top_k, 16)
    for key in ("sorted_token", "row_valid", "block_expert"):
        np.testing.assert_array_equal(plan[key].numpy(), np.asarray(ref[key]))
    np.testing.assert_allclose(plan["gates"].numpy(), np.asarray(ref["gates"]),
                               rtol=0, atol=1e-6)
    # every (token, slot) pair lands on a live row that feeds that token
    T = probs.shape[0]
    dest = plan["dest"]
    assert torch.equal(plan["sorted_token"][dest].long(),
                       torch.arange(T)[:, None].expand(T, CFG.top_k))
    assert bool((plan["row_valid"][dest] == 1.0).all())
    if case == "skew":
        top = moe.top_k_experts(torch.from_numpy(probs), 2)
        assert bool((top[:, 0] == 3).all()) and bool((top[:, 1] == 0).all())


# ---------------------------------------------------- kernels' plain versions

def _blocks_inputs(dtype, seed=4):
    """x_pad [NB, Bt, D] with zero padding rows and a block_expert that
    leaves some experts without a block, as a real plan does."""
    rng = np.random.default_rng(seed)
    NB, Bt = 6, 8
    x = rng.standard_normal((NB, Bt, CFG.dim)).astype(np.float32)
    x[2, 5:] = 0.0
    block_expert = np.array([0, 0, 3, 5, 5, 7], np.int32)
    return jnp.asarray(x, dtype), jnp.asarray(block_expert)


@pytest.mark.parametrize("dtype,act", [(jnp.float32, "silu"),
                                       (jnp.float32, "gelu"),
                                       (jnp.bfloat16, "silu")])
def test_expert_blocks_ref_matches_pallas(dtype, act):
    params = jax_moe.init_moe_params(CFG, jax.random.PRNGKey(0), dtype=dtype)
    x, be = _blocks_inputs(dtype)
    ref = jax_gm._expert_blocks_pallas(
        x, params["w1"], params["w3"], params["w2"], be, act=act, block=8,
        f_tile=32, interpret=True)
    tp = _tree(jax.device_get(params))
    torch_dtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    out = gm.expert_blocks_ref(_t(x).to(torch_dtype), tp["w1"].to(torch_dtype),
                               tp["w3"].to(torch_dtype),
                               tp["w2"].to(torch_dtype), _t(be), act)
    assert out.dtype == torch_dtype
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == jnp.float32 else \
        dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, dtype=np.float32), **tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_expert_blocks_q8_ref_matches_pallas(dtype):
    params = jax_qtree(dict(jax_moe.init_moe_params(CFG, jax.random.PRNGKey(0),
                                                    dtype=dtype)),
                       LOGICAL, scale_dtype=dtype)
    x, be = _blocks_inputs(dtype, seed=5)
    ref = jax_gm._expert_blocks_pallas_q8(
        x, params["w1"], params["w3"], params["w2"], be, act="silu", block=8,
        f_tile=32, interpret=True)
    tp = _tree(jax.device_get(params))
    torch_dtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    q8 = {k: {"q": tp[k]["q"], "s": tp[k]["s"].to(torch_dtype)}
          for k in ("w1", "w3", "w2")}
    assert q8["w1"]["q"].dtype == torch.int8
    out = gm.expert_blocks_q8_ref(_t(x).to(torch_dtype), q8["w1"], q8["w3"],
                                  q8["w2"], _t(be))
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == jnp.float32 else \
        dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, dtype=np.float32), **tol)


def test_cpu_tensors_run_the_plain_versions():
    """Wrappers handed CPU tensors run their plain versions, bit for bit,
    and count no kernel launch."""
    x, be = _blocks_inputs(jnp.float32)
    _, tp = _params()
    _, tq = _params(quant=True)
    x, be = _t(x), _t(be)
    counters = (gm.expert_blocks_tc, gm.expert_blocks_tc_q8,
                gm.expert_blocks_wmma, gm.expert_blocks_wmma_q8)
    before = tuple(fn.launches for fn in counters)
    assert torch.equal(gm.expert_blocks(x, tp["w1"], tp["w3"], tp["w2"], be),
                       gm.expert_blocks_ref(x, tp["w1"], tp["w3"], tp["w2"], be))
    assert torch.equal(
        gm.expert_blocks_q8(x, tq["w1"], tq["w3"], tq["w2"], be),
        gm.expert_blocks_q8_ref(x, tq["w1"], tq["w3"], tq["w2"], be))
    assert tuple(fn.launches for fn in counters) == before == (0, 0, 0, 0)


# ------------------------------------------------------------- FFN as a whole

@pytest.mark.parametrize("act,quant", [("silu", False), ("gelu", False),
                                       ("silu", True)])
def test_moe_ffn_matches_jax(act, quant):
    """Expert scan and grouped FFN against the JAX expert scan and grouped
    FFN (XLA path), and the two port formulations against each other."""
    params, tp = _params(quant)
    x = _x()
    dense = np.asarray(jax_moe.moe_ffn_dense_mask(params, x, CFG, act=act))
    grouped = np.asarray(jax_gm.moe_ffn_grouped(params, x, CFG, act=act,
                                                impl="xla", block=16))
    port_dense = moe.moe_ffn_dense_mask(tp, _t(x), PCFG, act=act).numpy()
    port_grouped = gm.moe_ffn_grouped(tp, _t(x), PCFG, act=act,
                                      block=16).numpy()
    np.testing.assert_allclose(port_dense, dense, **F32)
    np.testing.assert_allclose(port_grouped, grouped, **F32)
    tol = dict(rtol=1e-3, atol=1e-4) if quant else F32
    np.testing.assert_allclose(port_grouped, port_dense, **tol)


def test_extreme_skew_is_dropless():
    """All tokens routed to one expert, with an exact tie for the second
    slot: the grouped FFN must match the JAX expert scan."""
    params, tp = _params()
    params["router"] = jnp.asarray(_skew_router())
    tp["router"] = torch.from_numpy(_skew_router())
    x = np.abs(_x((1, 40), seed=9)) + 0.1
    dense = np.asarray(jax_moe.moe_ffn_dense_mask(params, x, CFG))
    np.testing.assert_allclose(gm.moe_ffn_grouped(tp, _t(x), PCFG,
                                                  block=16).numpy(), dense, **F32)
    np.testing.assert_allclose(moe.moe_ffn_dense_mask(tp, _t(x), PCFG).numpy(),
                               dense, **F32)


def test_moe_ffn_reference_matches_jax():
    params, tp = _params()
    x = _x()
    np.testing.assert_allclose(
        moe.moe_ffn_reference(tp, _t(x), PCFG).numpy(),
        np.asarray(jax_moe.moe_ffn_reference(params, x, CFG)), **F32)


def test_grouped_bf16_is_deterministic_and_matches_the_scan():
    """bf16 activations and stacks: the grouped FFN (which adds each
    token's k rows in slot order) gives the same bits on every call, and
    stays within bf16 rounding (3e-2) of the bf16 expert scan, which shares
    its routing."""
    _, tp = _params()
    x = _t(_x()).to(torch.bfloat16)
    tb = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    out = gm.moe_ffn_grouped(tb, x, PCFG, block=16)
    assert torch.equal(out, gm.moe_ffn_grouped(tb, x, PCFG, block=16))
    np.testing.assert_allclose(
        out.float().numpy(),
        moe.moe_ffn_dense_mask(tb, x, PCFG).float().numpy(),
        rtol=3e-2, atol=3e-2)


class _Cfg:
    """Just the fields ``_ffn_block`` reads."""
    dim = CFG.dim
    n_experts = CFG.n_experts
    ffn_hidden = CFG.expert_hidden
    moe_top_k = CFG.top_k
    hidden_act = "silu"
    moe_impl = "grouped_pallas"
    moe_block = 16


def test_ffn_block_gate():
    """Grouped only when T*k >= E*block: a decode-shaped [4, 1] batch takes
    the expert scan, a prefill-shaped [4, 32] batch the grouped path; both
    match the JAX expert scan."""
    params, tp = _params()
    small, big = _x((4, 1), seed=11), _x((4, 32), seed=12)
    with mock.patch.object(llama, "moe_ffn_grouped",
                           wraps=llama.moe_ffn_grouped) as spy:
        out = llama._ffn_block(tp, _Cfg(), _t(small))
        assert spy.call_count == 0
        grouped = llama._ffn_block(tp, _Cfg(), _t(big))
        assert spy.call_count == 1
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_moe.moe_ffn_dense_mask(params, small, CFG)),
        **F32)
    np.testing.assert_allclose(
        grouped.numpy(), np.asarray(jax_moe.moe_ffn_dense_mask(params, big, CFG)),
        **F32)


def test_grouped_flops_matches_jax():
    for T in (2048, 65536):
        assert gm.grouped_flops(T, 2, 8, 4096, 14336) == \
            jax_gm.grouped_flops(T, 2, 8, 4096, 14336)


# ------------------------------------------------------------ Mixtral forward

JAX_PREFILL = jax.jit(jax_llama.prefill, static_argnums=(1,),
                      static_argnames=("attn_impl",))


def test_mixtral_prefill_grouped_matches_jax():
    """mixtral-test (f32) with moe_impl=grouped_pallas and moe_block 8, so
    the 2x16 prefill clears the gate: the port's logits against the JAX
    package's (Pallas kernel in interpret mode) at atol 1e-4. (int8 stacks
    through the grouped path: tests/test_torch_moe_engine.py.)"""
    jcfg = dataclasses.replace(MODEL_CONFIGS["mixtral-test"],
                               moe_impl="grouped_pallas", moe_block=8)
    pcfg = dataclasses.replace(PORT["mixtral-test"],
                               moe_impl="grouped_pallas", moe_block=8)
    tree = jax.device_get(jax_llama.init_params(jcfg, jax.random.PRNGKey(0),
                                                dtype=jnp.float32))
    params = params_from_jax(tree, pcfg, device="cpu", dtype=torch.float32)
    from mcp_context_forge_tpu.tpu_local.kv import init_kv_state as jax_kv
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    positions = np.stack([np.arange(16)] * 2).astype(np.int32)
    positions[1, 10:] = -1
    slots = np.array([0, 1], np.int32)
    tables = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    jkv = jax_kv(jcfg, 16, 8, 2, 4, dtype=jnp.float32)._replace(
        block_tables=jnp.asarray(tables))
    pkv = init_kv_state(pcfg, 16, 8, 2, 4, dtype=torch.float32, device="cpu")
    pkv.block_tables.copy_(torch.from_numpy(tables))
    ref, _ = JAX_PREFILL(tree, jcfg, tokens, positions, jkv, slots,
                         attn_impl="reference")
    with mock.patch.object(llama, "moe_ffn_grouped",
                           wraps=llama.moe_ffn_grouped) as spy:
        out, _ = llama.prefill(params, pcfg, torch.from_numpy(tokens),
                               torch.from_numpy(positions), pkv,
                               torch.from_numpy(slots))
        assert spy.call_count == pcfg.n_layers
    valid = positions >= 0
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid],
                               rtol=0, atol=1e-4)
