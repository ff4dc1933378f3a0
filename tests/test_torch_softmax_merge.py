"""Port parity: ``ops/softmax_merge.py`` against ``tnn_tpu.ops.softmax_merge``.

``block_update``, ``merge`` and ``finalize`` against JAX's on the same
numpy-seeded states, and ``merge_shards`` (the port's per-shard form of
``merge_psum``) against ``merge_psum`` run under ``jax.vmap(...,
axis_name="seq")`` over the shard axis, at 2 and 4 shards. Both sides are
f32 on the CPU: they agree to 1e-6 relative (exp and the sums in another
order; at 2 shards the sums are the same two additions). The empty state
(NEG_INF, 0, 0) is an identity, and a row empty on every shard gives 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu.ops import softmax_merge as jsm
from tnn_tpu_torch.ops import softmax_merge as tsm

RTOL = 1e-6


def _state(rng, rows=6, dh=8, empty=()):
    """A partial (m, l, acc) per row; rows in ``empty`` saw no keys."""
    m = rng.normal(size=(rows, 1)).astype(np.float32) * 3
    l = rng.uniform(0.5, 4.0, size=(rows, 1)).astype(np.float32)  # noqa: E741
    acc = rng.normal(size=(rows, dh)).astype(np.float32) * l
    for r in empty:
        m[r], l[r], acc[r] = tsm.NEG_INF, 0.0, 0.0
    return m, l, acc


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_constants_match():
    assert tsm.NEG_INF == jsm.NEG_INF


def test_block_update_matches_jax():
    rng = np.random.default_rng(0)
    m, l, acc = _state(rng)
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    logits[2] = tsm.NEG_INF          # a fully masked block for one row
    v = rng.normal(size=(6, 5, 8)).astype(np.float32)
    want = jsm.block_update(jnp.asarray(m), jnp.asarray(l), jnp.asarray(acc),
                            jnp.asarray(logits[:, None]),
                            jnp.asarray(v))
    got = tsm.block_update(*_t(m, l, acc), *_t(logits[:, None], v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-6)


def test_merge_and_finalize_match_jax_with_identity():
    rng = np.random.default_rng(1)
    a = _state(rng, empty=(0,))
    b = _state(rng, empty=(0, 3))
    want = jsm.merge(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
    got = tsm.merge(tuple(_t(*a)), tuple(_t(*b)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    out = tsm.finalize(*got, dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jsm.finalize(*want, jnp.float32)),
                               rtol=RTOL)
    assert not out[0].any()          # empty on both sides: exactly 0
    # the empty state is an identity
    empty = _t(*_state(rng, empty=range(6)))
    same = tsm.merge(tuple(_t(*a)), tuple(empty))
    for g, w in zip(same[1:], _t(*a)[1:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shards", [2, 4])
def test_merge_shards_matches_merge_psum(shards):
    """Per-shard normalized outputs and stats, with one row empty on one
    shard and one row empty on every shard."""
    rng = np.random.default_rng(10 + shards)
    states = [_state(rng, empty=(5,) + ((1,) if s == 0 else ()))
              for s in range(shards)]
    outs = np.stack([acc / np.where(l == 0, 1, l) for _, l, acc in states])
    ms = np.stack([m for m, _, _ in states])
    ls = np.stack([l for _, l, _ in states])
    want = jax.vmap(lambda o, m, l: jsm.merge_psum(o, m, l, "seq"),
                    axis_name="seq")(jnp.asarray(outs), jnp.asarray(ms),
                                     jnp.asarray(ls))[0]
    got = tsm.merge_shards(_t(*outs), _t(*ms), _t(*ls))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-7)
    assert not got[5].any()          # empty on every shard: exactly 0
    # equal to merging the unnormalized states and finalizing
    merged = tuple(_t(*states[0]))
    for st in states[1:]:
        merged = tsm.merge(merged, tuple(_t(*st)))
    np.testing.assert_allclose(got.numpy(), tsm.finalize(*merged).numpy(),
                               rtol=1e-5, atol=1e-7)


def test_merge_shards_keeps_dtype_and_matches_two_shard_psum():
    rng = np.random.default_rng(3)
    states = [_state(rng) for _ in range(2)]
    outs = [torch.from_numpy(acc / l).bfloat16() for _, l, acc in states]
    got = tsm.merge_shards(outs, *[_t(*[st[i] for st in states])
                                   for i in (0, 1)])
    assert got.dtype == torch.bfloat16
    # f32 at two shards: the psum's own two additions; only exp differs
    outs32 = np.stack([acc / l for _, l, acc in states])
    ms = np.stack([m for m, _, _ in states])
    ls = np.stack([l for _, l, _ in states])
    want = jax.vmap(lambda o, m, l: jsm.merge_psum(o, m, l, "seq"),
                    axis_name="seq")(jnp.asarray(outs32), jnp.asarray(ms),
                                     jnp.asarray(ls))[0]
    got32 = tsm.merge_shards(_t(*outs32), _t(*ms), _t(*ls))
    np.testing.assert_allclose(got32.numpy(), np.asarray(want), rtol=2e-7)
