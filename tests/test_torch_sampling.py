"""The port's sampler: greedy exactly equal to the JAX package's, the sampled
path checked as a distribution against a numpy oracle of the reference
pipeline (sort -> top-k -> softmax(T) -> top-p inclusive -> draw). JAX keys
cannot be reproduced with a torch.Generator, so draws are compared in
distribution, as tests/test_sampling.py does for the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.core import sampling as jsampling
from qwen3_tts_tpu_torch.core import sampling


def oracle_probs(logits, temperature, top_k, top_p):
    """(candidate indices, probabilities) after top-k / top-p."""
    order = np.argsort(-logits, kind="stable")
    if 0 < top_k < len(order):
        order = order[:top_k]
    vals = logits[order].astype(np.float64)
    probs = np.exp((vals - vals[0]) / temperature)
    probs /= probs.sum()
    if top_p < 1.0:
        cum = np.cumsum(probs)
        cutoff = int(np.searchsorted(cum, top_p)) + 1
        order, probs = order[:cutoff], probs[:cutoff]
        probs = probs / probs.sum()
    return order, probs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_equals_jax(seed):
    logits = np.random.default_rng(seed).normal(size=(4, 2160)).astype(
        np.float32)
    got = sampling.sample(torch.from_numpy(logits), None, 0.0, 40, 0.9)
    want = jsampling.sample(jnp.asarray(logits), jax.random.key(0), 0.0, 40,
                            0.9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_ties_take_lowest_index():
    logits = torch.zeros(2, 16)
    logits[0, [3, 9]] = 5.0
    logits[1, [0, 15]] = 1.0
    assert sampling.greedy_sample(logits).tolist() == [3, 0]
    assert sampling.sample(logits, None, 0.7, 0, 1.0).shape == (2,)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 40, 0.9), (1.0, 0, 1.0), (0.5, 5, 0.6)])
def test_sampled_distribution_matches_oracle(temperature, top_k, top_p):
    logits = (np.random.default_rng(3).normal(size=(64,)) * 2).astype(
        np.float32)
    cand, probs = oracle_probs(logits, temperature, top_k, top_p)
    n = 20000
    g = torch.Generator().manual_seed(0)
    batch = torch.from_numpy(np.tile(logits, (n, 1)))
    draws = sampling.sample(batch, g, temperature, top_k, top_p).numpy()
    assert set(np.unique(draws)) <= set(cand.tolist())
    freq = np.asarray([(draws == c).mean() for c in cand])
    # 5 standard errors of a binomial frequency at n draws
    tol = 5 * np.sqrt(probs * (1 - probs) / n) + 1e-3
    assert np.all(np.abs(freq - probs) <= tol), (freq, probs)


def test_sampling_is_reproducible_from_generator_seed():
    logits = torch.randn(8, 256, generator=torch.Generator().manual_seed(1))
    a = sampling.sample(logits, torch.Generator().manual_seed(5), 0.8, 40,
                        0.9)
    b = sampling.sample(logits, torch.Generator().manual_seed(5), 0.8, 40,
                        0.9)
    assert torch.equal(a, b)
