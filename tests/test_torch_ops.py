"""The port's attention ops against the JAX package's Pallas kernels (run in
interpret mode on the CPU, as the JAX package's own tests run them) and its
plain references, on the same seeded numpy inputs, in f32.

Tolerance: rtol = atol = 2e-5. Both sides accumulate in f32; only the order
of the sums differs (blockwise online softmax against one softmax). Int8
pages dequantize exactly alike on both sides (int8 x f32 scale in f32), so
they keep the same tolerance.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local.models.llama import (
    _history_attention as jax_history_attention,
    _paged_decode_attention as jax_paged_decode_attention,
)
from mcp_context_forge_tpu.tpu_local.ops.attention import (
    attention_reference as jax_attention_reference,
    flash_attention_pallas,
)
from mcp_context_forge_tpu.tpu_local.ops.paged_attention import (
    paged_chunk_attention_pallas,
    paged_decode_attention_pallas,
)
from mcp_context_forge_tpu_torch.tpu_local.ops import attention as port_attn
from mcp_context_forge_tpu_torch.tpu_local.ops import paged_attention as port_paged

TOL = dict(rtol=2e-5, atol=2e-5)


class _Geo:
    """Just the fields the JAX references read."""

    def __init__(self, n_kv_heads, n_heads):
        self.n_kv_heads, self.n_heads = n_kv_heads, n_heads


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _paged_inputs(rng, B, P, page, KV, hd):
    """Random pages and per-row block tables over distinct pages (page 0
    stays the trash page)."""
    num_pages = B * P + 1
    k_pages = rng.standard_normal((num_pages, page, KV, hd), dtype=np.float32)
    v_pages = rng.standard_normal((num_pages, page, KV, hd), dtype=np.float32)
    tables = (1 + rng.permutation(B * P)).reshape(B, P).astype(np.int32)
    return k_pages, v_pages, tables


def _gathered(pages, tables):
    B, P = tables.shape
    return pages[tables].reshape(B, P * pages.shape[1], *pages.shape[2:])


@pytest.mark.parametrize("B,S,KV,G,hd,valid_lens", [
    (2, 16, 2, 2, 16, (16, 11)),   # llama3-test geometry, right padding
    (2, 16, 1, 4, 32, (9, 16)),    # gemma-test geometry (MQA)
])
def test_flash_matches_pallas_and_reference(B, S, KV, G, hd, valid_lens):
    rng = np.random.default_rng(0)
    H = KV * G
    q = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    valid = np.arange(S)[None, :] < np.asarray(valid_lens)[:, None]

    out = port_attn.flash_attention(_t(q), _t(k), _t(v), _t(valid)).numpy()
    ref = np.asarray(jax_attention_reference(q, k, v, valid))
    np.testing.assert_allclose(out, ref, **TOL)
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.repeat(k, G, axis=2), jnp.repeat(v, G, axis=2),
        jnp.asarray(valid), block_q=8, block_k=8, interpret=True))
    for b, n in enumerate(valid_lens):  # padding rows are never read
        np.testing.assert_allclose(out[b, :n], pallas[b, :n], **TOL)


@pytest.mark.parametrize("KV,G,hd,page,seq_lens", [
    (2, 2, 16, 8, (13, 5, 20)),    # llama3-test geometry
    (8, 4, 64, 16, (19, 33)),      # llama3-1b geometry
])
def test_decode_matches_pallas_and_reference(KV, G, hd, page, seq_lens):
    rng = np.random.default_rng(1)
    B = len(seq_lens)
    P = -(-max(seq_lens) // page)
    k_pages, v_pages, tables = _paged_inputs(rng, B, P, page, KV, hd)
    q = rng.standard_normal((B, KV, G, hd), dtype=np.float32)
    lens = np.asarray(seq_lens, dtype=np.int32)

    out = port_paged.paged_decode_attention(
        _t(q), _t(k_pages), _t(v_pages), _t(tables), _t(lens)).numpy()
    pallas = np.asarray(paged_decode_attention_pallas(
        q, k_pages, v_pages, tables, lens, page_size=page, interpret=True))
    np.testing.assert_allclose(out, pallas, **TOL)
    ref = np.asarray(jax_paged_decode_attention(
        q.reshape(B, KV * G, hd), _gathered(k_pages, tables),
        _gathered(v_pages, tables), lens, _Geo(KV, KV * G)))
    np.testing.assert_allclose(out, ref.reshape(B, KV, G, hd), **TOL)


def test_decode_empty_row_is_zero():
    rng = np.random.default_rng(2)
    k_pages, v_pages, tables = _paged_inputs(rng, 2, 2, 8, 2, 16)
    q = rng.standard_normal((2, 2, 2, 16), dtype=np.float32)
    out = port_paged.paged_decode_attention(
        _t(q), _t(k_pages), _t(v_pages), _t(tables),
        torch.tensor([0, 9], dtype=torch.int32))
    assert torch.count_nonzero(out[0]) == 0
    assert torch.count_nonzero(out[1]) > 0


@pytest.mark.parametrize("KV,G,hd,page", [(2, 2, 16, 8), (1, 4, 32, 4)])
def test_chunk_matches_pallas_and_reference(KV, G, hd, page):
    rng = np.random.default_rng(3)
    B, S, P = 3, 8, 6
    k_pages, v_pages, tables = _paged_inputs(rng, B, P, page, KV, hd)
    q = rng.standard_normal((B, S, KV, G, hd), dtype=np.float32)
    # per-row history offsets; row 1 is half padding (position -1)
    starts, lens = (5, 0, 16), (8, 4, 8)
    pos = np.full((B, S), -1, dtype=np.int32)
    for b, (start, n) in enumerate(zip(starts, lens)):
        pos[b, :n] = np.arange(start, start + n)
    valid = pos >= 0

    out = port_paged.paged_chunk_attention(
        _t(q), _t(k_pages), _t(v_pages), _t(tables), _t(pos)).numpy()
    pallas = np.asarray(paged_chunk_attention_pallas(
        q, k_pages, v_pages, tables, pos, page_size=page, interpret=True))
    ref = np.asarray(jax_history_attention(
        q.reshape(B, S, KV * G, hd), _gathered(k_pages, tables),
        _gathered(v_pages, tables), np.maximum(pos, 0), valid,
        _Geo(KV, KV * G))).reshape(B, S, KV, G, hd)
    np.testing.assert_allclose(out[valid], pallas[valid], **TOL)
    np.testing.assert_allclose(out[valid], ref[valid], **TOL)
    assert np.isfinite(out).all()


def _int8_pages(rng, B, P, page, KV, hd):
    """Random int8 pages over distinct pages, with per-(page, kv-head)
    positive f32 scales [num_pages, KV]."""
    num_pages = B * P + 1
    k_pages, v_pages = (rng.integers(-127, 128, (num_pages, page, KV, hd),
                                     dtype=np.int8) for _ in range(2))
    k_scales, v_scales = (rng.uniform(0.2, 2.0, (num_pages, KV))
                          .astype(np.float32) / 127 for _ in range(2))
    tables = (1 + rng.permutation(B * P)).reshape(B, P).astype(np.int32)
    return k_pages, v_pages, k_scales, v_scales, tables


@pytest.mark.parametrize("kind", ["decode", "chunk"])
@pytest.mark.parametrize("KV,G,hd,page", [(2, 2, 16, 8), (8, 4, 64, 16)])
def test_int8_pages_match_pallas(kind, KV, G, hd, page):
    """Both wrappers with scales against the Pallas kernels' quantized
    bodies (``k_scales``/``v_scales``, interpret mode) and the plain
    version; the CPU call runs the q8 plain version, not a launch."""
    rng = np.random.default_rng(5)
    B, P = 3, 4
    kp, vp, ks, vs, tables = _int8_pages(rng, B, P, page, KV, hd)
    scales = dict(k_scales=ks, v_scales=vs)
    if kind == "decode":
        q = rng.standard_normal((B, KV, G, hd), dtype=np.float32)
        lens = np.asarray([P * page, 5, 0], dtype=np.int32)
        out = port_paged.paged_decode_attention(
            *(_t(a) for a in (q, kp, vp, tables, lens, ks, vs))).numpy()
        pallas = np.asarray(paged_decode_attention_pallas(
            q, kp, vp, tables, lens, page_size=page, interpret=True, **scales))
        ref = port_paged.paged_decode_attention_q8(
            *(_t(a) for a in (q, kp, vp, tables, lens, ks, vs))).numpy()
        assert not out[2].any()
        rows = slice(None)
    else:
        S = 8
        q = rng.standard_normal((B, S, KV, G, hd), dtype=np.float32)
        pos = np.full((B, S), -1, dtype=np.int32)
        for b, (start, n) in enumerate([(5, 8), (0, 4), (P * page - 8, 8)]):
            pos[b, :n] = np.arange(start, start + n)
        out = port_paged.paged_chunk_attention(
            *(_t(a) for a in (q, kp, vp, tables, pos, ks, vs))).numpy()
        pallas = np.asarray(paged_chunk_attention_pallas(
            q, kp, vp, tables, pos, page_size=page, interpret=True, **scales))
        ref = port_paged.paged_chunk_attention_q8(
            *(_t(a) for a in (q, kp, vp, tables, pos, ks, vs))).numpy()
        assert np.isfinite(out).all()
        rows = pos >= 0
    np.testing.assert_allclose(out[rows], pallas[rows], **TOL)
    np.testing.assert_array_equal(out, ref)
    assert port_paged.paged_decode_attention_q8.launches == 0
    assert port_paged.paged_chunk_attention_tc_q8.launches == 0
    assert port_paged.paged_chunk_attention_mma_q8.launches == 0


def test_scales_come_in_pairs():
    rng = np.random.default_rng(6)
    kp, vp, ks, _, tables = (_t(a) for a in _int8_pages(rng, 1, 1, 8, 2, 16))
    q = torch.zeros((1, 2, 2, 16))
    with pytest.raises(ValueError, match="together"):
        port_paged.paged_decode_attention(q, kp, vp, tables,
                                          torch.tensor([3], dtype=torch.int32),
                                          k_scales=ks)


def test_cpu_tensors_run_the_plain_versions():
    """A wrapper handed CPU tensors runs its plain version, bit for bit,
    and never counts a kernel launch."""
    rng = np.random.default_rng(4)
    counters = (port_attn.flash_attention_tc, port_attn.flash_attention_mma,
                port_paged.paged_decode_attention,
                port_paged.paged_decode_attention_q8,
                port_paged.paged_chunk_attention_tc,
                port_paged.paged_chunk_attention_tc_q8,
                port_paged.paged_chunk_attention_mma,
                port_paged.paged_chunk_attention_mma_q8)
    before = [fn.launches for fn in counters]
    q = _t(rng.standard_normal((1, 8, 4, 16), dtype=np.float32))
    k = _t(rng.standard_normal((1, 8, 2, 16), dtype=np.float32))
    valid = torch.ones((1, 8), dtype=torch.bool)
    assert torch.equal(port_attn.flash_attention(q, k, k, valid),
                       port_attn.attention_reference(q, k, k, valid))
    kp, vp, tables = (_t(a) for a in _paged_inputs(rng, 1, 2, 8, 2, 16))
    lens = torch.tensor([11], dtype=torch.int32)
    qd = q[:, 0].reshape(1, 2, 2, 16)
    assert torch.equal(
        port_paged.paged_decode_attention(qd, kp, vp, tables, lens),
        port_paged.paged_decode_attention_ref(qd, kp, vp, tables, lens))
    qc = q.reshape(1, 8, 2, 2, 16)
    pos = torch.arange(3, 11, dtype=torch.int32)[None]
    assert torch.equal(
        port_paged.paged_chunk_attention(qc, kp, vp, tables, pos),
        port_paged.paged_chunk_attention_ref(qc, kp, vp, tables, pos))
    scales = torch.full((kp.shape[0], 2), 0.5)
    k8, v8 = (torch.round(p * 20).clamp(-127, 127).to(torch.int8)
              for p in (kp, vp))
    assert torch.equal(
        port_paged.paged_decode_attention(qd, k8, v8, tables, lens,
                                          scales, scales),
        port_paged.paged_decode_attention_ref(qd, k8, v8, tables, lens,
                                              scales, scales))
    assert torch.equal(
        port_paged.paged_chunk_attention(qc, k8, v8, tables, pos, scales,
                                         scales),
        port_paged.paged_chunk_attention_ref(qc, k8, v8, tables, pos, scales,
                                             scales))
    assert [fn.launches for fn in counters] == before == [0] * 8


def test_scale_is_inverse_sqrt_head_dim():
    """One key: the output is that key's value whatever the scale; two keys
    pin the 1/sqrt(hd) scaling of the scores."""
    hd = 16
    q = torch.zeros((1, 1, 1, 1, hd))
    q[..., 0] = 1.0
    kp = torch.zeros((3, 2, 1, hd))
    vp = torch.zeros((3, 2, 1, hd))
    kp[1, 1, 0, 0] = math.sqrt(hd) * math.log(3.0)   # score ln 3 vs 0
    vp[1, 0, 0, 0], vp[1, 1, 0, 0] = 0.0, 1.0
    out = port_paged.paged_chunk_attention(
        q, kp, vp, torch.tensor([[1]], dtype=torch.int32),
        torch.tensor([[1]], dtype=torch.int32))
    assert float(out[0, 0, 0, 0, 0]) == pytest.approx(0.75, abs=1e-6)
