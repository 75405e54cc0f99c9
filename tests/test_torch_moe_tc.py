"""The numerics of the tensor-core grouped-expert kernels on the CPU: their
plain model ``expert_blocks_split_ref`` (h in f32, split into bf16 hi and
lo halves, the down-projection as hi @ w2 + lo @ w2 in f32) against the
JAX package's Pallas kernels in interpret mode at mixtral-test widths;
that the card's row check sees an h that lost its lo half; and the static
route with the wrappers that refuse what the kernel does not take.

Tolerances: f32 outputs rtol 1e-4 / atol 1e-5 against the Pallas kernels
(the split keeps h to 2^-17 of each value, and F tiles sum in another
order); bf16 outputs 2e-2 (one bf16 rounding of the output, plus the order
of f32 sums). The row check is ``chip_smoke.py``'s ``MOE_ROW_RMS``: each
row's ||out - ref||_2 within that share of ||ref||_2.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local.ops import grouped_moe as jax_gm
from mcp_context_forge_tpu.tpu_local.parallel import moe as jax_moe
from mcp_context_forge_tpu.tpu_local.quantize import quantize_tree as jax_qtree
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS as PORT
from mcp_context_forge_tpu_torch.tpu_local.ops import grouped_moe as gm
from mcp_context_forge_tpu_torch.tpu_local.parallel.moe import activation
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

MIX = PORT["mixtral-test"]
CFG = jax_moe.MoEConfig(dim=MIX.dim, n_experts=MIX.n_experts,
                        expert_hidden=MIX.ffn_hidden, top_k=MIX.moe_top_k)
LOGICAL = {"router": "replicated", "w1": "moe_up", "w3": "moe_up",
           "w2": "moe_down"}
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32)
                        if np.asarray(a).dtype.name == "bfloat16"
                        else np.asarray(a))


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return _t(tree)


def _blocks_inputs(dtype, seed=4):
    """x_pad [NB, 8, D] with zero padding rows; experts 1 and 2 own no
    block, as in a real plan."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((5, 8, CFG.dim)).astype(np.float32)
    x[1, 6:] = 0.0
    return jnp.asarray(x, dtype), jnp.asarray(np.array([0, 0, 3, 3, 3], np.int32))


def _tol(dtype):
    return dict(rtol=1e-4, atol=1e-5) if dtype == jnp.float32 else \
        dict(rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype,act", [(jnp.float32, "silu"),
                                       (jnp.float32, "gelu"),
                                       (jnp.bfloat16, "silu"),
                                       (jnp.bfloat16, "gelu")])
def test_split_model_matches_pallas(dtype, act):
    params = jax_moe.init_moe_params(CFG, jax.random.PRNGKey(0), dtype=dtype)
    x, be = _blocks_inputs(dtype)
    ref = jax_gm._expert_blocks_pallas(
        x, params["w1"], params["w3"], params["w2"], be, act=act, block=8,
        f_tile=32, interpret=True)
    tp = _tree(jax.device_get(params))
    torch_dtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    out = gm.expert_blocks_split_ref(
        _t(x).to(torch_dtype), tp["w1"].to(torch_dtype),
        tp["w3"].to(torch_dtype), tp["w2"].to(torch_dtype), _t(be), act)
    assert out.dtype == torch_dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, dtype=np.float32), **_tol(dtype))


@pytest.mark.parametrize("dtype,act", [(jnp.float32, "silu"),
                                       (jnp.bfloat16, "gelu")])
def test_split_model_matches_pallas_q8(dtype, act):
    params = jax_qtree(dict(jax_moe.init_moe_params(CFG, jax.random.PRNGKey(1),
                                                    dtype=dtype)),
                       LOGICAL, scale_dtype=dtype)
    x, be = _blocks_inputs(dtype, seed=5)
    ref = jax_gm._expert_blocks_pallas_q8(
        x, params["w1"], params["w3"], params["w2"], be, act=act, block=8,
        f_tile=32, interpret=True)
    tp = _tree(jax.device_get(params))
    torch_dtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    q8 = {k: {"q": tp[k]["q"], "s": tp[k]["s"].to(torch_dtype)}
          for k in ("w1", "w3", "w2")}
    out = gm.expert_blocks_split_ref(_t(x).to(torch_dtype), q8["w1"], q8["w3"],
                                     q8["w2"], _t(be), act)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, dtype=np.float32), **_tol(dtype))


def _row_rms(out, ref):
    o, r = out.float(), ref.float()
    return (o - r).norm(dim=-1) / r.norm(dim=-1)


def test_dropping_lo_exceeds_the_row_bound():
    """At Mixtral's model width (D 4096; F cut to 4096, since the measure is a
    per-row ratio of norms) with bf16 weights: the split model reads each
    row well inside the card's bound, and the same product over hi alone
    (h rounded once to bf16) reads every row above it, while the max-based
    row check (1e-2 of the row's largest value) cannot see it."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(7)
    D, F, rows = 4096, 4096, 32

    def weights(shape, fan_in):
        w = rng.standard_normal(shape, dtype=np.float32) / np.sqrt(fan_in)
        return torch.from_numpy(w).to(torch.bfloat16)

    x = torch.from_numpy(rng.standard_normal((1, rows, D), dtype=np.float32)
                         ).to(torch.bfloat16)
    w1, w3 = weights((1, D, F), D), weights((1, D, F), D)
    w2 = weights((1, F, D), F)
    be = torch.zeros(1, dtype=torch.int32)
    ref = gm.expert_blocks_ref(x, w1, w3, w2, be)[0]
    split = gm.expert_blocks_split_ref(x, w1, w3, w2, be)[0]
    xf = x[0].float()
    h = activation(xf @ w1[0].float(), "silu") * (xf @ w3[0].float())
    hi_only = (h.to(torch.bfloat16).float() @ w2[0].float()).to(torch.bfloat16)
    assert float(_row_rms(split, ref).max()) <= smoke.MOE_ROW_RMS / 4
    assert float(_row_rms(hi_only, ref).min()) > smoke.MOE_ROW_RMS
    max_rel = ((hi_only.float() - ref.float()).abs().amax(-1)
               / ref.float().abs().amax(-1))
    assert float(max_rel.max()) < smoke.ROW_REL


def _route_cases():
    mix = PORT["mixtral-8x7b"]
    return [
        (torch.bfloat16, 128, mix.dim, mix.ffn_hidden, "tc"),
        (torch.bfloat16, 64, mix.dim, mix.ffn_hidden, "tc"),
        (torch.bfloat16, 8, mix.dim, mix.ffn_hidden, "wmma"),     # moe_block 8
        (torch.bfloat16, 96, mix.dim, mix.ffn_hidden, "wmma"),    # half a warpgroup
        (torch.float32, 128, mix.dim, mix.ffn_hidden, "wmma"),
        (torch.bfloat16, 128, MIX.dim, MIX.ffn_hidden, "wmma"),   # mixtral-test
        (torch.bfloat16, 128, 4096 + 128, 14336, "wmma"),         # D off the 256 tile
        (torch.bfloat16, 128, 4096, 14336 + 64, "wmma"),          # F off the 128 tile
        (torch.float16, 128, 4096, 14336, "wmma"),
    ]


@pytest.mark.parametrize("dtype,Bt,D,F,route", _route_cases())
def test_moe_route_is_static(dtype, Bt, D, F, route):
    assert gm.moe_route(dtype, Bt, D, F) == route


@pytest.mark.parametrize("dtype,Bt,D,F", [
    (torch.bfloat16, 8, 256, 128),      # Bt 8
    (torch.float32, 64, 256, 128),      # f32
    (torch.bfloat16, 64, 264, 128),     # D off the tile
    (torch.bfloat16, 64, 256, 136),     # F off the tile
])
def test_tc_wrappers_refuse_before_any_launch(dtype, Bt, D, F):
    E, NB = 2, 2
    x = torch.zeros((NB, Bt, D), dtype=dtype)
    be = torch.zeros(NB, dtype=torch.int32)
    up, down = torch.zeros((E, D, F), dtype=dtype), torch.zeros((E, F, D), dtype=dtype)
    before = (gm.expert_blocks_tc.launches, gm.expert_blocks_tc_q8.launches)
    with pytest.raises(ValueError, match="takes bf16"):
        gm.expert_blocks_tc(x, up, up, down, be)
    q_up = {"q": up.to(torch.int8), "s": torch.ones((E, F), dtype=dtype)}
    q_down = {"q": down.to(torch.int8), "s": torch.ones((E, D), dtype=dtype)}
    with pytest.raises(ValueError, match="takes bf16"):
        gm.expert_blocks_tc_q8(x, q_up, q_up, q_down, be)
    assert (gm.expert_blocks_tc.launches, gm.expert_blocks_tc_q8.launches) == before


def test_cpu_dispatch_takes_the_plain_version_at_tc_shapes():
    """A geometry the tensor-core route takes still runs the plain version
    on CPU tensors, bit for bit, with no launch counted."""
    rng = np.random.default_rng(9)
    E, NB, Bt, D, F = 2, 2, 64, 256, 128
    x = torch.from_numpy(rng.standard_normal((NB, Bt, D), dtype=np.float32)
                         ).to(torch.bfloat16)
    w = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32) / 16).to(torch.bfloat16)
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    be = torch.tensor([1, 0], dtype=torch.int32)
    assert gm.moe_route(x.dtype, Bt, D, F) == "tc"
    counters = (gm.expert_blocks_tc, gm.expert_blocks_tc_q8,
                gm.expert_blocks_wmma, gm.expert_blocks_wmma_q8)
    before = [fn.launches for fn in counters]
    assert torch.equal(gm.expert_blocks(x, *w, be), gm.expert_blocks_ref(x, *w, be))
    assert [fn.launches for fn in counters] == before
