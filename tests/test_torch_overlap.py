"""The port's depth-2 overlapped decode pipeline and decode widths against
the JAX engine's, on the CPU: greedy streams equal at K = 1 with the
pipeline on and off; page pressure (a small pool and a short max_seq_len)
that delays admissions and truncates rows at the table's end, with equal
finish reasons and pages in use; and ``batch_buckets`` at max_batch 16
(widths 8 and 16), whose finishes leave holes that ``_compact_slots``
closes."""

import pytest

from torch_engine_pair import TEXTS, make_pair, serve_both


@pytest.fixture(scope="module", params=[True, False], ids=["overlap", "serial"])
def pair(request):
    return make_pair(superstep=1, decode_overlap=request.param)


def test_greedy_streams_equal(pair):
    ref, port = pair
    tok = port.tokenizer
    jobs = [(tok.encode(text), dict(max_tokens=m))
            for text, m in zip(TEXTS, (13, 11, 5, 20))]
    outs = serve_both(pair, jobs)
    assert [len(t) for t, _ in outs] == [13, 11, 5, 20]
    assert port.stats.decode_steps == port.stats.decode_dispatches
    assert (port.stats.overlap_steps > 0) == port.config.decode_overlap


def test_page_pressure_truncates_like_jax():
    """19 usable pages of 8 tokens and max_seq_len 64 (8 pages a row): the
    admissions wait for pages, and rows whose prompt and max_tokens pass
    64 end "length" at 65 tokens, through partial super-step budgets."""
    pair = make_pair(superstep=4, max_seq_len=64, num_pages=20)
    ref, port = pair
    tok = port.tokenizer
    prompts = [tok.encode(text * 4) for text in TEXTS]
    jobs = [(ids, dict(max_tokens=40)) for ids in prompts]
    outs = serve_both(pair, jobs)
    totals = [len(ids) + len(tokens) for ids, (tokens, _) in zip(prompts, outs)]
    assert all(reason == "length" for _, reason in outs)
    assert any(total == 65 and len(ids) + 40 > 65
               for ids, total in zip(prompts, totals)), totals
    assert port.allocator.pages_in_use == ref.allocator.pages_in_use == 0
    assert port.stats.pipeline_drains > 0


def test_batch_buckets_with_compaction_like_jax():
    """Ten requests at max_batch 16 (widths 8 and 16): finishes at
    different lengths leave holes that compaction closes (``move_slot`` in
    both engines). The port captures every width when it is built, so it
    starts at 16, the JAX engine's warmed start; an unwarmed JAX engine
    starts at 8, so the two compact at different dispatches, and only the
    streams, finishes and pages are held equal."""
    pair = make_pair(superstep=2, max_batch=16, batch_buckets=True,
                     batch_shrink_steps=2, num_pages=128)
    ref, port = pair
    tok = port.tokenizer
    moves = {}
    for name, engine in (("ref", ref), ("port", port)):
        move = engine.allocator.move_slot

        def counted(old, new, move=move, name=name):
            moves[name] = moves.get(name, 0) + 1
            move(old, new)

        engine.allocator.move_slot = counted
    jobs = [(tok.encode(f"{TEXTS[i % 2]} {i}"), dict(max_tokens=2 + 2 * (i % 4)))
            for i in range(10)]
    serve_both(pair, jobs)
    assert moves.get("port", 0) > 0 and moves.get("ref", 0) > 0
    assert port._batch_buckets() == [8, 16]
