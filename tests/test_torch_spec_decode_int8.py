"""The port's speculative decoding against the JAX engine's on int8 KV pages
(``spec_k`` 3), and where the page pool or max_tokens cut a verify short,
on the CPU in f32. Greedy streams, finish reasons and the spec counters
must equal ``TPUEngine(spec_decode=True)``'s exactly. On int8 pages a
rejected draft's KV may grow its page's scale in both engines alike, so
the streams are held to the JAX engine's own int8 spec streams."""

import pytest

from torch_engine_pair import make_pair, prompt_jobs, serve_spec


@pytest.fixture(scope="module")
def int8_pair():
    return make_pair(kv_quant="int8", spec_decode=True, spec_k=3)


def test_int8_pages_greedy_streams_equal_jax(int8_pair):
    ref, port = int8_pair
    outs, deltas = serve_spec(int8_pair, prompt_jobs(port.tokenizer))
    assert [len(t) for t, _ in outs] == [16] * 4
    assert deltas["spec_steps"] > 0 and deltas["spec_tokens"] > 0
    assert port.kv.quantized


def test_max_tokens_and_page_capacity_truncate_alike():
    """The JAX spec test's capacity case (a 32-position table, pages of 16,
    8 pages): a 6-token prompt asking for 30 tokens ends "length" when its
    two pages are full, and a request whose max_tokens ends inside a
    verify chunk emits exactly max_tokens."""
    pair = make_pair(spec_decode=True, spec_k=4, max_seq_len=32,
                     prefill_buckets=(16,), num_pages=8, page_size=16)
    outs, _ = serve_spec(pair, [([5, 5, 5, 5, 5, 5], dict(max_tokens=30))])
    assert 1 <= len(outs[0][0]) <= 27 and outs[0][1] == "length"
    outs, _ = serve_spec(pair, [([7, 8, 9, 7, 8, 9, 7, 8], dict(max_tokens=3))])
    assert len(outs[0][0]) == 3 and outs[0][1] == "length"
