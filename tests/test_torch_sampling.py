"""The port's sampler against the JAX package's: greedy is exact, the
top-k/top-p masks are the same masks, and the draw follows the masked
softmax (a seeded chi-square test; the two packages' random streams
differ by construction, so draws are compared by distribution)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local import sampling as jax_sampling
from mcp_context_forge_tpu_torch.tpu_local.sampling import (
    SamplingParams, sample_tokens, sampling_mask)
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)


def _params(temperature, top_k, top_p):
    return SamplingParams(torch.tensor(temperature, dtype=torch.float32),
                          torch.tensor(top_k, dtype=torch.int32),
                          torch.tensor(top_p, dtype=torch.float32))


def test_greedy_is_argmax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 300)).astype(np.float32)
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1.0   # tie: first index
    gen = torch.Generator().manual_seed(0)
    out = sample_tokens(torch.from_numpy(logits),
                        _params([0.0] * 6, [0] * 6, [1.0] * 6), gen)
    np.testing.assert_array_equal(out.numpy(), np.argmax(logits, axis=-1))
    jax_out = jax_sampling.sample_tokens(
        jnp.asarray(logits), jax_sampling.default_sampling(6),
        jax.random.PRNGKey(0))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_out))


def test_mask_matches_jax(monkeypatch):
    """Capture the masked logits JAX's sample_tokens hands to its draw and
    compare the drawable sets exactly."""
    rng = np.random.default_rng(1)
    B, V = 8, 64
    # unit-scale logits: no token's probability sits below f32 rounding of
    # the cumulative sum, where top_p = 1.0 would hinge on summation order
    logits = rng.standard_normal((B, V)).astype(np.float32)
    temperature = [1.0, 0.7, 1.3, 1.0, 0.5, 2.0, 1.0, 0.9]
    top_k = [0, 5, 0, 1, 20, 3, 64, 70]
    top_p = [1.0, 1.0, 0.9, 0.5, 0.8, 1.0, 0.3, 0.95]
    captured = {}
    real = jax.random.categorical

    def spy(key, masked, axis=-1):
        captured["masked"] = np.asarray(masked)
        return real(key, masked, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", spy)
    jax_sampling.sample_tokens(
        jnp.asarray(logits),
        jax_sampling.SamplingParams(jnp.asarray(temperature, jnp.float32),
                                    jnp.asarray(top_k, jnp.int32),
                                    jnp.asarray(top_p, jnp.float32)),
        jax.random.PRNGKey(0))
    jax_mask = np.isfinite(captured["masked"])
    temp = torch.tensor(temperature)[:, None]
    mask = sampling_mask(torch.from_numpy(logits) / temp,
                         torch.tensor(top_k, dtype=torch.int32),
                         torch.tensor(top_p))
    np.testing.assert_array_equal(mask.numpy(), jax_mask)


def test_top_k_one_is_argmax():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((16, 50)).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    for _ in range(5):
        out = sample_tokens(logits, _params([1.0] * 16, [1] * 16, [1.0] * 16),
                            gen)
        assert torch.equal(out, logits.argmax(dim=-1))


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (3, 1.0), (0, 0.7)])
def test_draw_distribution_chi_square(top_k, top_p):
    """20000 seeded draws over a 6-token vocab against the masked softmax:
    the chi-square statistic stays under the 0.999 quantile of its
    distribution (df <= 5: 20.5)."""
    logits = torch.tensor([[1.0, 0.5, 0.0, -0.5, 1.5, -1.0]])
    N = 20000
    gen = torch.Generator().manual_seed(1234)
    params = _params([1.0] * N, [top_k] * N, [top_p] * N)
    draws = sample_tokens(logits.expand(N, -1).contiguous(), params, gen)
    mask = sampling_mask(logits, torch.tensor([top_k]), torch.tensor([top_p]))[0]
    probs = torch.softmax(torch.where(mask, logits[0], -torch.inf), dim=-1)
    counts = torch.bincount(draws, minlength=6).double()
    assert counts[~mask].sum() == 0
    expected = probs[mask].double() * N
    chi2 = float(((counts[mask] - expected) ** 2 / expected).sum())
    assert chi2 < 20.5


def test_sample_tokens_reads_nothing_back(monkeypatch):
    """Neither variant reads a device value on the host (a CUDA graph holds
    the call): with ``Tensor.__bool__`` and ``Tensor.item`` raising, both
    still run."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((4, 40)).astype(np.float32))
    params = _params([0.0, 0.8, 1.0, 0.0], [0, 5, 0, 0], [1.0, 0.9, 1.0, 1.0])
    gen = torch.Generator().manual_seed(5)

    def refuse(*args, **kwargs):
        raise AssertionError("sample_tokens read a tensor value on the host")

    monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    for any_sampled in (False, True):
        assert sample_tokens(logits, params, gen, any_sampled).shape == (4,)


def test_greedy_only_variant_matches_sampling_variant():
    """The greedy-only call (``any_sampled=False``) and the sampling call
    give the same tokens on every greedy row of a mixed batch."""
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.standard_normal((8, 100)).astype(np.float32))
    temperature = [0.0, 0.9, 0.0, 1.2, 0.0, 0.0, 0.5, 0.0]
    params = _params(temperature, [0, 10, 0, 0, 3, 0, 0, 1], [1.0] * 8)
    greedy_rows = torch.tensor(temperature) == 0.0
    only = sample_tokens(logits, params, torch.Generator().manual_seed(7), False)
    mixed = sample_tokens(logits, params, torch.Generator().manual_seed(7), True)
    assert torch.equal(only, logits.argmax(dim=-1))
    assert torch.equal(mixed[greedy_rows], only[greedy_rows])


def test_tempered_masked_draw_chi_square():
    """The Gumbel-max draw at temperature 0.7 under top-k 4 and top-p 0.8
    together (top-p keeps 3 of top-k's 4): 20000 seeded draws against the
    masked softmax of the tempered logits, under the 0.999 quantile of
    chi-square with 2 degrees of freedom (13.8)."""
    logits = torch.tensor([[2.0, 1.2, 0.3, -0.4, 1.6, -1.1, 0.9]])
    N = 20000
    params = _params([0.7] * N, [4] * N, [0.8] * N)
    draws = sample_tokens(logits.expand(N, -1).contiguous(), params,
                          torch.Generator().manual_seed(99))
    scaled = logits / 0.7
    mask = sampling_mask(scaled, torch.tensor([4]), torch.tensor([0.8]))[0]
    assert int(mask.sum()) == 3
    probs = torch.softmax(torch.where(mask, scaled[0], -torch.inf), dim=-1)
    counts = torch.bincount(draws, minlength=7).double()
    assert counts[~mask].sum() == 0
    expected = probs[mask].double() * N
    chi2 = float(((counts[mask] - expected) ** 2 / expected).sum())
    assert chi2 < 13.8
