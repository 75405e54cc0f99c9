"""The port's K-step decode super-steps against the JAX engine's, on the
CPU: greedy streams equal at K = 8 with the overlapped pipeline on and
off, a stop id and EOS sampled in the middle of a super-step, max_tokens
tails shorter than K, the super-step's own device masks (budget and stop
freezes), and the allocator's super-step pieces (``pregrant_block``,
``move_slot``) against the JAX allocator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local.kv import PageAllocator as JaxAllocator
from mcp_context_forge_tpu.tpu_local.sampling import \
    SamplingParams as JaxSampling
from mcp_context_forge_tpu_torch.tpu_local.kv import PageAllocator
from mcp_context_forge_tpu_torch.tpu_local.sampling import SamplingParams
from torch_engine_pair import TEXTS, first_new_token, make_pair, serve_both
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

K = 8


@pytest.fixture(scope="module", params=[True, False], ids=["overlap", "serial"])
def pair(request):
    return make_pair(superstep=K, decode_overlap=request.param)


def _jobs(tok, max_tokens=(13, 11, 5, 20), **fields):
    return [(tok.encode(text), dict(max_tokens=m, **fields))
            for text, m in zip(TEXTS, max_tokens)]


def test_greedy_streams_equal(pair):
    """Tails of 4, 2 and 3 tokens after whole super-steps (max_tokens 13,
    11 and 20 less the prefill token) and a request shorter than K."""
    ref, port = pair
    outs = serve_both(pair, _jobs(port.tokenizer))
    assert [len(t) for t, _ in outs] == [13, 11, 5, 20]
    assert all(reason == "length" for _, reason in outs)
    assert port.stats.decode_dispatches < port.stats.decode_steps
    if port.config.decode_overlap:
        assert port.stats.overlap_steps > 0


def test_stop_id_and_eos_mid_superstep(pair):
    """A stop id, then EOS, first sampled inside the first super-step: the
    stream ends there with "stop" in both engines, nothing past it."""
    ref, port = pair
    tok = port.tokenizer
    (stream, _), = serve_both(pair, _jobs(tok)[3:])
    stop_at = first_new_token(stream, 2)
    assert stop_at < K   # inside the first super-step (tokens 1 to K)
    outs = serve_both(pair, _jobs(tok, stop_ids=(stream[stop_at],)))
    assert outs[3] == (stream[:stop_at + 1], "stop")
    eos_at = first_new_token(stream, stop_at + 1)
    eos = (ref.tokenizer.eos_id, port.tokenizer.eos_id)
    try:
        ref.tokenizer.eos_id = port.tokenizer.eos_id = stream[eos_at]
        outs = serve_both(pair, _jobs(tok)[3:])
    finally:
        ref.tokenizer.eos_id, port.tokenizer.eos_id = eos
    assert outs[0] == (stream[:eos_at + 1], "stop")
    assert ref.allocator.pages_in_use == port.allocator.pages_in_use == 0


def test_superstep_masks_match_jax(pair):
    """``_decode_and_sample`` called directly on both engines at k = 4,
    one row active and one empty: its budget freeze (2 of 4 tokens), then
    its stop freeze (the first token in the stop table): the same masks
    and the same valid tokens."""
    ref, port = pair
    B, W, k = 2, 4, 4
    for alloc in (ref.allocator, port.allocator):
        assert alloc.allocate_slot(0, 16)
    ref._sync_tables()
    port._sync_tables()
    tokens, positions, seq_lens = [3, 0], [4, 0], [5, 0]

    def run(budgets, stops):
        stop_tbl = np.full((B, W), -1, np.int32)
        stop_tbl[0, :len(stops)] = stops
        (jt, jv, jd), _ = ref._decode_and_sample(
            ref.params, ref.kv, jnp.asarray(tokens, jnp.int32),
            jnp.asarray(positions, jnp.int32), jnp.arange(B, dtype=jnp.int32),
            jnp.asarray(seq_lens, jnp.int32), jnp.asarray(budgets, jnp.int32),
            jnp.asarray(stop_tbl),
            JaxSampling(jnp.zeros(B), jnp.zeros(B, jnp.int32), jnp.ones(B)),
            jax.random.PRNGKey(0), ctx_pages=2, k=k)
        i32 = dict(dtype=torch.int32)
        pt, pv, pd, _ = port._decode_and_sample(
            torch.tensor(tokens, **i32), torch.tensor(positions, **i32),
            torch.tensor(seq_lens, **i32), torch.tensor(budgets, **i32),
            torch.from_numpy(stop_tbl),
            SamplingParams(torch.zeros(B), torch.zeros(B, **i32), torch.ones(B)),
            torch.arange(B, **i32), k=k, any_sampled=False)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
        # tokens past a row's freeze are discarded: each engine computes
        # them from its own pool, which the JAX call never updates
        np.testing.assert_array_equal(np.where(pv.numpy(), pt.numpy(), -1),
                                      np.where(np.asarray(jv), np.asarray(jt), -1))
        return pt.numpy(), pv.numpy(), pd.numpy()

    try:
        toks, valid, done = run([2, 0], [])
        assert list(valid[:, 0]) == [True, True, False, False]
        assert not valid[:, 1].any() and not done.any()
        toks, valid, done = run([k, 0], [int(toks[0, 0])])
        assert list(valid[:, 0]) == [True, False, False, False]
        assert bool(done[0]) and not bool(done[1])
    finally:
        for alloc in (ref.allocator, port.allocator):
            alloc.free_slot(0)


@pytest.mark.parametrize("case", ["grants", "moves"])
def test_allocator_superstep_pieces_match_jax(case):
    """``pregrant_block`` budgets (whole, partial at the slot's last page,
    zero when the pool is dry, zero for k = 0) and ``move_slot``: the same
    returns, tables, footprints and free pages as the JAX allocator."""
    allocs = [JaxAllocator(12, 4, 4, 5), PageAllocator(12, 4, 4, 5)]

    def both(method, *args):
        results = [getattr(a, method)(*args) for a in allocs]
        assert results[0] == results[1], (method, args, results)
        return results[1]

    both("allocate_slot", 0, 5)
    both("allocate_slot", 2, 3)
    if case == "grants":
        assert both("pregrant_block", 0, 6, 8) == 8
        assert both("pregrant_block", 0, 14, 8) == 7   # the slot's 5 pages: 20 tokens
        assert both("pregrant_block", 0, 21, 8) == 0
        assert both("pregrant_block", 2, 3, 0) == 0
        both("allocate_slot", 1, 16)
        assert both("pregrant_block", 2, 4, 8) == 5    # the pool runs dry
    else:
        both("move_slot", 2, 1)
        both("move_slot", 0, 3)
        both("free_slot", 1)
        both("allocate_slot", 0, 4)
        both("move_slot", 3, 1)
    for method in ("avg_slot_pages", "free_pages", "pages_in_use"):
        values = [getattr(a, method) for a in allocs]
        values = [v() if callable(v) else v for v in values]
        assert values[0] == values[1], method
    for slot in range(4):
        assert allocs[0].slot_pages(slot) == allocs[1].slot_pages(slot)
    np.testing.assert_array_equal(allocs[1].tables().numpy(),
                                  np.asarray(allocs[0].tables()))
