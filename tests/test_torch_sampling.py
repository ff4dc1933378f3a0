"""Port parity: per-row sampling filters and the sampler.

``filter_logits`` is compared with JAX's on the same numpy logits and
per-row temperature / top-k / top-p: the kept set is identical and kept
values agree to 1e-6 relative (float32 division and softmax). The two
frameworks' random bits differ, so the sampler is checked by its contract:
greedy rows take the argmax, sampled tokens stay inside the filtered
support, and a seeded generator repeats itself.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu.models import sampling as jsampling
from tnn_tpu_torch.models import sampling

NEG = sampling.NEG_INF / 2


def _logits(seed, rows=6, vocab=64):
    return (np.random.default_rng(seed).normal(size=(rows, vocab))
            ).astype(np.float32)


PARAMS = (np.array([0.0, 0.7, 1.3, 1.0, 0.8, 2.0], np.float32),   # t
          np.array([0, 5, 0, 64, 17, 1], np.int32),                # k
          np.array([0.0, 0.0, 0.9, 0.5, 1.0, 0.3], np.float32))    # p


def _near_top_p_boundary(x, t, k, p, eps=1e-6):
    """Tokens whose probability mass before them (after the top-k cut) lies
    within ``eps`` of the row's top-p threshold: there the two frameworks'
    cumulative sums, taken in different orders, may fall on either side
    (even at p = 1, "keep all", where the running sum reaches 1 - ulp)."""
    xs = torch.from_numpy(x) / torch.from_numpy(np.where(t > 0, t, 1))[:, None]
    xs = sampling.filter_logits(xs, 1.0, torch.from_numpy(k), 1.0)
    down, order = torch.sort(xs, dim=-1, descending=True)
    probs = torch.softmax(down, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    p_eff = torch.from_numpy(np.where((p > 0) & (p < 1), p, 1.0))[:, None]
    near = torch.zeros_like(xs, dtype=torch.bool)
    near.scatter_(1, order, (before - p_eff).abs() < eps)
    return (near & (xs > NEG)).numpy()   # top-k cuts are exact on both sides


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_logits_matches_jax(seed):
    x = _logits(seed)
    t, k, p = PARAMS
    ref = np.asarray(jsampling.filter_logits(jnp.asarray(x), jnp.asarray(t),
                                             jnp.asarray(k), jnp.asarray(p)))
    out = sampling.filter_logits(torch.from_numpy(x), torch.from_numpy(t),
                                 torch.from_numpy(k), torch.from_numpy(p))
    out = out.numpy()
    decided = ~_near_top_p_boundary(x, t, k, p)
    assert decided.mean() > 0.95
    np.testing.assert_array_equal((out > NEG)[decided], (ref > NEG)[decided])
    keep = (ref > NEG) & (out > NEG)
    np.testing.assert_allclose(out[keep], ref[keep], rtol=1e-6)


def test_filter_logits_scalar_params_match_jax():
    x = _logits(5)
    ref = np.asarray(jsampling.filter_logits(jnp.asarray(x), 0.9, 10, 0.8))
    out = sampling.filter_logits(torch.from_numpy(x), 0.9, 10, 0.8).numpy()
    decided = ~_near_top_p_boundary(x, np.full(6, 0.9, np.float32),
                                    np.full(6, 10), np.full(6, 0.8))
    np.testing.assert_array_equal((out > NEG)[decided], (ref > NEG)[decided])


def test_greedy_rows_take_argmax_and_sampled_rows_stay_in_support():
    x = torch.from_numpy(_logits(7))
    t, k, p = (torch.from_numpy(a) for a in PARAMS)
    support = sampling.filter_logits(x, t, k, p) > NEG
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(200):
        tok = sampling.sample_ragged(x, gen, t, k, p)
        assert tok.dtype == torch.int64
        assert tok[0] == x[0].argmax()                # t = 0: greedy
        assert tok[5] == x[5].argmax()                # k = 1: one survivor
        assert support[torch.arange(6), tok].all()
        seen.add(int(tok[2]))
    assert len(seen) > 1                              # it does sample


def test_seeded_generator_repeats():
    x = torch.from_numpy(_logits(8))
    t = torch.full((6,), 1.0)
    a = sampling.sample_ragged(x, torch.Generator().manual_seed(3), t, 0, 0.0)
    b = sampling.sample_ragged(x, torch.Generator().manual_seed(3), t, 0, 0.0)
    assert torch.equal(a, b)
