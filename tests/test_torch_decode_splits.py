"""The split-K decode kernel's host plan and a plain model of its arithmetic
(partials over whole-page splits, then the combine), against the port's
plain decode and the JAX package's Pallas decode kernel (interpret mode, as
its own tests run it), on the same seeded numpy inputs; and the static
choices of the flash and paged chunk wrappers between their kernels. CPU
only, a few seconds.

Tolerance: rtol = atol = 2e-5 in f32. The split model sums each split
separately and takes base-2 exponentials, so only the order and the
rounding of the sums differ from one softmax over the row.
"""

import functools

import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local.ops.paged_attention import (
    paged_decode_attention_pallas,
)
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.ops import attention as port_attn
from mcp_context_forge_tpu_torch.tpu_local.ops import paged_attention as port_paged
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

TOL = dict(rtol=2e-5, atol=2e-5)
B, KV, G, HD, PAGE, P = 5, 2, 3, 16, 8, 6
# row 0 is empty, row 2 is longer than all others and fills its table,
# row 1 ends inside its first page, so most splits of rows 0, 1 and 3
# hold no key
SEQ_LENS = (0, 5, P * PAGE, 19, 33)


@pytest.mark.parametrize("P_,B_,KV_,sms", [
    (16, 8, 8, 132),    # llama3-8b at max_seq_len 2048, max_batch 8
    (64, 8, 8, 132),    # llama3-8b at 8192
    (16, 1, 8, 132),    # one row: one slot per split
    (1, 1, 1, 132),
    (7, 3, 2, 132),
    (200, 64, 8, 132),  # enough rows to fill the card without splitting
    (5, 2, 4, 8),
    (64, 1, 1, 132),
])
def test_split_plan_covers_whole_pages(P_, B_, KV_, sms):
    pps, splits = port_paged.decode_split_plan(P_, B_, KV_, sms)
    assert pps >= 1 and splits >= 1
    assert splits * pps >= P_ > (splits - 1) * pps   # every slot, no empty split
    per_sm = port_paged.DECODE_CTAS_PER_SM
    assert splits * B_ * KV_ >= min(per_sm * sms, P_ * B_ * KV_)


def test_split_plan_fills_the_card_at_the_smoke_shapes():
    for P_ in (16, 64):
        pps, splits = port_paged.decode_split_plan(P_, 8, 8, 132)
        assert splits * 8 * 8 >= 2 * 132


def test_split_plan_refuses_an_empty_grid():
    with pytest.raises(ValueError, match=">= 1"):
        port_paged.decode_split_plan(0, 8, 8, 132)
    with pytest.raises(ValueError, match=">= 1"):
        port_paged.decode_split_plan(16, 0, 8, 132)


@functools.lru_cache(maxsize=None)
def _inputs(kind):
    """Seeded pages over distinct table slots (page 0 is the trash page):
    f32 values that bf16 holds exactly, or int8 with [N, KV] scales."""
    rng = np.random.default_rng(11)
    N = B * P + 1
    q = rng.standard_normal((B, KV, G, HD), dtype=np.float32)
    if kind == "bf16":
        def pages():
            x = torch.from_numpy(rng.standard_normal((N, PAGE, KV, HD),
                                                     dtype=np.float32))
            return x.to(torch.bfloat16).float().numpy()
        kp, vp, scales = pages(), pages(), {}
    else:
        kp, vp = (rng.integers(-127, 128, (N, PAGE, KV, HD), dtype=np.int8)
                  for _ in range(2))
        scales = {name: rng.uniform(0.2, 2.0, (N, KV)).astype(np.float32) / 127
                  for name in ("k_scales", "v_scales")}
    tables = (1 + rng.permutation(B * P)).reshape(B, P).astype(np.int32)
    seq = np.asarray(SEQ_LENS, dtype=np.int32)
    pallas = np.asarray(paged_decode_attention_pallas(
        q, kp, vp, tables, seq, page_size=PAGE, interpret=True, **scales))
    return q, kp, vp, tables, seq, scales, pallas


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("pps", [1, 2, 4, P])
def test_split_model_matches_plain_and_pallas(kind, pps):
    q, kp, vp, tables, seq, scales, pallas = _inputs(kind)
    t = {k: torch.from_numpy(v) for k, v in scales.items()}
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, seq)]
    ml, o = port_paged.decode_partials_ref(*args, pps, **t)
    splits = -(-P // pps)
    assert ml.shape == (B, KV, splits, G, 2) and o.shape == (B, KV, splits, G, HD)
    out = port_paged.decode_combine_ref(ml, o, args[4], PAGE, pps, P).numpy()
    plain = port_paged.paged_decode_attention_ref(*args, **t).numpy()
    rows = seq > 0
    np.testing.assert_allclose(out[rows], plain[rows], **TOL)
    np.testing.assert_allclose(out[rows], pallas[rows], **TOL)
    assert not out[~rows].any() and not plain[~rows].any()
    # a split that holds no key: m = -1e30, l = 0, o = 0
    for b, n in enumerate(SEQ_LENS):
        for s in range(splits):
            empty = s * pps * PAGE >= n
            assert bool((ml[b, :, s, :, 1] == 0).all()) == empty
            if empty:
                assert bool((ml[b, :, s, :, 0] == port_paged.NEG_INF).all())
                assert not o[b, :, s].any()


def test_dropping_one_split_moves_only_its_row():
    """Dropping one split's partial (m = -1e30, l = 0, o = 0) leaves the
    other rows alone and moves the row it belongs to past the 1e-2 row
    check: what the chip smoke's planted fault relies on."""
    q, kp, vp, tables, seq, scales, _ = _inputs("bf16")
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, seq)]
    ml, o = port_paged.decode_partials_ref(*args, 2)
    right = port_paged.decode_combine_ref(ml, o, args[4], PAGE, 2, P)
    ml[2, :, 1, :, 0], ml[2, :, 1, :, 1], o[2, :, 1] = port_paged.NEG_INF, 0.0, 0.0
    fault = port_paged.decode_combine_ref(ml, o, args[4], PAGE, 2, P)
    assert torch.equal(fault[[0, 1, 3, 4]], right[[0, 1, 3, 4]])
    rel = ((fault[2] - right[2]).abs().amax() / right[2].abs().amax()).item()
    assert rel > 1e-2


def test_decode_kernel_refuses_what_it_does_not_hold():
    """Checked before anything reaches the card."""
    tables = torch.ones((1, 2), dtype=torch.int32)
    lens = torch.tensor([3], dtype=torch.int32)
    pages = torch.zeros((3, 8, 1, 16))
    with pytest.raises(ValueError, match="query heads"):
        port_paged._decode_launch("d", "s", torch.zeros((1, 1, 17, 16)), pages,
                                  pages, tables, lens, None, None)
    pages8 = torch.zeros((3, 8, 1, 24), dtype=torch.int8)
    with pytest.raises(ValueError, match="16-byte"):
        port_paged._decode_launch("d", "s", torch.zeros((1, 1, 2, 24)), pages8,
                                  pages8, tables, lens, None, None)


def _route_cases():
    """(kernel, dtype, hd, page, route) for every head dim of MODEL_CONFIGS
    (16, 32, 64, 128, 256) in bf16 and f32, at the engine's page of 128
    for the chunk kernel, and the page sizes and dtypes around the choice."""
    hds = sorted({cfg.head_dim for cfg in MODEL_CONFIGS.values()})
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for hd in hds:
            tc = dtype == torch.bfloat16 and hd in (64, 128)
            cases.append(("flash", dtype, hd, None, "tc" if tc else "mma"))
            cases.append(("chunk", dtype, hd, 128, "tc" if tc else "mma"))
    cases += [
        ("flash", torch.float16, 128, None, "mma"),
        ("chunk", torch.float16, 128, 128, "mma"),
        ("chunk", torch.bfloat16, 128, 64, "tc"),
        ("chunk", torch.bfloat16, 64, 256, "tc"),
        ("chunk", torch.bfloat16, 128, 16, "mma"),   # pages smaller than a key tile
        ("chunk", torch.bfloat16, 128, 96, "mma"),   # pages of a partial key tile
    ]
    return cases


@pytest.mark.parametrize("kernel,dtype,hd,page,route", _route_cases())
def test_flash_route_is_static_by_dtype_and_head_dim(kernel, dtype, hd, page,
                                                     route):
    """Both prefill routes are static: flash by (dtype, hd), the paged
    chunk kernel by (query dtype, hd, page size)."""
    assert sorted({cfg.head_dim for cfg in MODEL_CONFIGS.values()}) == [
        16, 32, 64, 128, 256]
    if kernel == "flash":
        assert port_attn.flash_route(dtype, hd) == route
    else:
        assert port_paged.chunk_route(dtype, hd, page) == route


def test_flash_tc_refuses_what_it_does_not_take():
    valid = torch.ones((1, 4), dtype=torch.bool)
    for dtype, hd in ((torch.float32, 128), (torch.bfloat16, 32)):
        q = torch.zeros((1, 4, 2, hd), dtype=dtype)
        with pytest.raises(ValueError, match="takes bf16"):
            port_attn.flash_attention_tc(q, q, q, valid)
    assert port_attn.flash_attention_tc.launches == 0


def test_chunk_tc_refuses_what_it_does_not_take():
    """The tensor-core chunk wrappers refuse f32, other head dims and pages
    that do not hold whole 64-key tiles before anything reaches the card."""
    tables = torch.ones((1, 1), dtype=torch.int32)
    pos = torch.zeros((1, 4), dtype=torch.int32)
    for dtype, hd, page in ((torch.float32, 128, 128), (torch.bfloat16, 32, 128),
                            (torch.bfloat16, 128, 32)):
        q = torch.zeros((1, 4, 1, 2, hd), dtype=dtype)
        pages = torch.zeros((2, page, 1, hd), dtype=dtype)
        with pytest.raises(ValueError, match="takes bf16"):
            port_paged.paged_chunk_attention_tc(q, pages, pages, tables, pos)
        scales = torch.ones((2, 1), dtype=dtype)
        pages8 = pages.to(torch.int8)
        with pytest.raises(ValueError, match="takes bf16"):
            port_paged.paged_chunk_attention_tc_q8(q, pages8, pages8, tables, pos,
                                                   scales, scales)
    assert port_paged.paged_chunk_attention_tc.launches == 0
    assert port_paged.paged_chunk_attention_tc_q8.launches == 0
