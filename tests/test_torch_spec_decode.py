"""The port's speculative decoding against the JAX engine's, on the CPU in
f32: prompt-lookup drafts and a [B, K] verify through the history path.
Spec decode is lossless, so greedy streams, finish reasons and the spec
counters must equal ``TPUEngine(spec_decode=True)``'s exactly (and the
port's own plain decoding's): the prompts of the JAX package's spec tests
plus a cyclic one, a chunked prompt and a prefix hit, sampled rows riding
the verify at width one beside greedy rows. Also ``_draft_tokens``
against the JAX method on seeded random contexts, and the config
validation."""

import numpy as np
import pytest

from mcp_context_forge_tpu.tpu_local.engine import GenRequest as JaxRequest
from mcp_context_forge_tpu_torch.tpu_local.engine import (EngineConfig,
                                                          GenRequest,
                                                          TorchEngine)
from torch_engine_pair import SHAPE, make_pair, prompt_jobs, serve, serve_spec

K = 4


@pytest.fixture(scope="module")
def pair():
    return make_pair(spec_decode=True, spec_k=K)


def test_greedy_streams_equal_jax_and_plain_decode(pair):
    ref, port = pair
    jobs = prompt_jobs(port.tokenizer)
    outs, deltas = serve_spec(pair, jobs)
    assert [len(t) for t, _ in outs] == [16] * 4
    assert deltas["spec_steps"] > 0 and deltas["spec_tokens"] > 0
    plain = TorchEngine(EngineConfig(**SHAPE, device="cpu"), params=port.params)
    assert serve(plain, jobs) == outs
    assert deltas["decode_dispatches"] < plain.stats.decode_dispatches


def test_chunked_prefill_and_prefix_hit(pair):
    """A 70-token prompt chunks (64 + 6) and registers 8 full pages; then a
    prompt sharing its first 64 tokens hits them and prefills a 20-token
    suffix; both decode by verify."""
    ref, port = pair
    base = [(7 + 13 * i) % 200 for i in range(70)]
    long_job = [(base, dict(max_tokens=12))]
    outs, _ = serve_spec(pair, long_job)
    assert len(outs[0][0]) == 12
    hits = [e.allocator.prefix_hits for e in pair]
    hit_job = [(base[:64] + [(3 + 5 * i) % 200 for i in range(20)],
                dict(max_tokens=10))]
    outs, deltas = serve_spec(pair, hit_job)
    assert len(outs[0][0]) == 10 and deltas["spec_steps"] > 0
    assert [e.allocator.prefix_hits - h for e, h in zip(pair, hits)] == [1, 1]


def test_sampled_rows_ride_at_width_one(pair):
    """A greedy row and a sampled row share the verify: the greedy stream
    equals JAX's, the sampled row emits one token per dispatch (spec
    tokens come from the greedy row alone, so they equal JAX's) and both
    end "length" at max_tokens in both engines."""
    ref, port = pair
    jobs = [([3, 4, 5, 3, 4, 5, 3, 4], dict(max_tokens=8)),
            ([10, 11, 12, 13], dict(max_tokens=8, temperature=0.8, top_k=20))]
    names = ("spec_steps", "spec_tokens", "decode_dispatches")
    before = [{n: getattr(e.stats, n) for n in names} for e in pair]
    want, got = serve(ref, jobs), serve(port, jobs)
    deltas = [{n: getattr(e.stats, n) - b[n] for n in names}
              for e, b in zip(pair, before)]
    assert got[0] == want[0]
    assert [(len(t), r) for t, r in got] == [(len(t), r) for t, r in want] \
        == [(8, "length"), (8, "length")]
    assert deltas[1] == deltas[0] and deltas[1]["spec_steps"] > 0


def test_draft_tokens_match_jax(pair):
    """Seeded random contexts over a 6-token vocabulary (n-grams recur),
    long enough to reach past the 512-token scan window, at n-gram lengths
    1-3 and draft widths 1-3."""
    ref, port = pair
    rng = np.random.default_rng(5)
    ngram = (ref.config.spec_ngram, port.config.spec_ngram)
    drafted = 0
    try:
        for case in range(60):
            n = int(rng.integers(1, 4))
            ref.config.spec_ngram = port.config.spec_ngram = n
            size = int(rng.choice([1, 2, 5, 40, 700]))
            ctx = rng.integers(0, 6 if case % 2 else 60, size).tolist()
            split = int(rng.integers(1, size + 1))
            a = JaxRequest(request_id="a", prompt_ids=ctx[:split], generated=ctx[split:])
            b = GenRequest(request_id="b", prompt_ids=ctx[:split], generated=ctx[split:])
            for k in (1, 2, 3):
                got = port._draft_tokens(b, k)
                assert got == ref._draft_tokens(a, k)
                drafted += bool(got)
    finally:
        ref.config.spec_ngram, port.config.spec_ngram = ngram
    assert drafted > 30


@pytest.mark.parametrize("field,value,message", [
    ("superstep", 2, "mutually exclusive"),
    ("spec_k", 1, "spec_k must be >= 2"),
    ("spec_ngram", 0, "spec_ngram must be >= 1"),
])
def test_config_validation(field, value, message):
    with pytest.raises(ValueError, match=message):
        TorchEngine(EngineConfig(**SHAPE, spec_decode=True, device="cpu",
                                 **{field: value}))
