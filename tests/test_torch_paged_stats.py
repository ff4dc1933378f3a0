"""Port parity: the stats form of ragged paged attention (K1s), the
partial a sequence-parallel shard hands the merge.

``paged_attention(..., return_stats=True)`` on CPU tensors (its plain
version) returns ``(out, m, l)``; it is held against the JAX package's
``paged_attention(..., return_stats=True)`` on the XLA reference and on
the Pallas kernel in interpret mode, on the same numpy-seeded inputs, over
f32 and int8 pages, decode and ragged forms, with -1 holes, a kv_len-0
row, padding tokens and a row whose blocks are all holes. Both sides are
f32 on the CPU and differ in summation order only: out within 2e-5
absolute (O(1) values), m within 1e-5 relative, l within 1e-5 relative.
Dead rows read exactly (0, -1e30, 0) on both. bf16 pages are held against
JAX's f32 reference on the same bf16-rounded inputs (not every XLA:CPU
build runs a bf16 x bf16 -> f32 dot): out to 1.5e-2 as for K1, m and l to
f32 rounding, since the scores are f32 on both sides.

Split-and-merge: each row's blocks go round-robin to 2 and 4 tables (-1
where another table holds the block), the stats form runs on each, and
``softmax_merge.merge_shards`` combines them: equal to unsharded attention
within 2e-5. The CUDA kernel itself runs only on the card
(``test_stats_kernel_matches_plain_on_card``, marked ``cuda``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu.ops.pallas import paged_attention as jpa
from tnn_tpu_torch.ops import paged_attention as tpa
from tnn_tpu_torch.ops.softmax_merge import NEG_INF, merge_shards
from test_torch_paged_attention import force_splits

ATOL = 2e-5
STAT_RTOL = 1e-5


def _case(seed, *, block_size, heads, q_width, batch=5, num_layers=2,
          num_blocks=30, head_dim=16, blocks_per_row=4, holes=True):
    """Pages, tables and ragged lengths: a kv_len-0 row, a full row, a
    one-token row, a row whose blocks are all -1 holes; a hole inside the
    full row; padding tokens past q_lens."""
    h, hkv = heads
    rng = np.random.default_rng(seed)
    shape = (num_layers, num_blocks, hkv, block_size, head_dim)
    pk = rng.normal(size=shape).astype(np.float32)
    pv = rng.normal(size=shape).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_blocks))[:batch * blocks_per_row]
    tables = perm.reshape(batch, blocks_per_row).astype(np.int32)
    cap = blocks_per_row * block_size
    kv_lens = rng.integers(q_width, cap + 1, size=batch).astype(np.int32)
    q_lens = rng.integers(1, q_width + 1, size=batch).astype(np.int32)
    kv_lens[0], q_lens[0] = 0, 0          # a dead row
    kv_lens[1] = cap                      # a full row
    kv_lens[2], q_lens[2] = 1, 1          # a one-token row
    for i in range(batch):
        tables[i, math.ceil(kv_lens[i] / block_size):] = 0
    if holes:
        tables[1, 1] = -1                 # a hole in the full row
        tables[4] = -1                    # a live row with only holes
    q = rng.normal(size=(batch, q_width, h, head_dim)).astype(np.float32)
    return q, pk, pv, tables, kv_lens, q_lens


def _quant(pk, pv):
    """int8 pages as the pool writes them (the port's quantizer, which
    equals JAX's bit for bit: tests/test_torch_quant_serving.py)."""
    out = []
    for p in (pk, pv):
        d, s = tpa.quantize_kv_rows(torch.from_numpy(p))
        out.append((d.numpy(), s.numpy()))
    return out


def _pages(quant, pk, pv, lib):
    if not quant:
        return (jnp.asarray(pk), jnp.asarray(pv)) if lib == "jax" else \
            (torch.from_numpy(pk), torch.from_numpy(pv))
    (kd, ks), (vd, vs) = _quant(pk, pv)
    if lib == "jax":
        return (jpa.QuantPages(jnp.asarray(kd), jnp.asarray(ks)),
                jpa.QuantPages(jnp.asarray(vd), jnp.asarray(vs)))
    return (tpa.QuantPages(torch.from_numpy(kd), torch.from_numpy(ks)),
            tpa.QuantPages(torch.from_numpy(vd), torch.from_numpy(vs)))


def _port(q, pages, tables, kv_lens, q_lens, layer, decode):
    tq = torch.from_numpy(q[:, 0] if decode else q)
    return tpa.paged_attention(
        tq, *pages, torch.from_numpy(tables), torch.from_numpy(kv_lens),
        q_lens=None if decode else torch.from_numpy(q_lens), layer=layer,
        return_stats=True)


def _jax(q, pages, tables, kv_lens, q_lens, layer, decode, **kw):
    return jpa.paged_attention(
        jnp.asarray(q[:, 0] if decode else q), *pages, jnp.asarray(tables),
        jnp.asarray(kv_lens), q_lens=None if decode else jnp.asarray(q_lens),
        layer=layer, return_stats=True, **kw)


def _assert_close(got, want):
    out, m, l = (x.numpy() for x in got)  # noqa: E741
    jout, jm, jl = (np.asarray(x) for x in want)
    assert out.shape == jout.shape and m.shape == jm.shape == l.shape
    np.testing.assert_allclose(out, jout, atol=ATOL, rtol=0)
    np.testing.assert_allclose(m, jm, rtol=STAT_RTOL, atol=1e-6)
    np.testing.assert_allclose(l, jl, rtol=STAT_RTOL, atol=0)
    dead = jl == 0
    assert dead.any()
    assert (m[dead] == NEG_INF).all() and (l[dead] == 0).all()
    assert not out[np.broadcast_to(dead, out.shape)].any()
    assert (l[~dead] > 0).all()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("q_width", [1, 4, 8])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa2"])
def test_stats_match_jax_reference(quant, q_width, heads):
    q, pk, pv, tables, kv_lens, q_lens = _case(
        20 + q_width + heads[1], block_size=4, heads=heads, q_width=q_width)
    decode = q_width == 1
    got = _port(q, _pages(quant, pk, pv, "torch"), tables, kv_lens, q_lens,
                1, decode)
    want = _jax(q, _pages(quant, pk, pv, "jax"), tables, kv_lens, q_lens, 1,
                decode, backend="xla")
    _assert_close(got, want)
    # the output equals the softmax form's
    plain = tpa.paged_attention_reference(
        torch.from_numpy(q[:, 0] if decode else q),
        *_pages(quant, pk, pv, "torch"), torch.from_numpy(tables),
        torch.from_numpy(kv_lens),
        q_lens=None if decode else torch.from_numpy(q_lens), layer=1)
    np.testing.assert_allclose(got[0].numpy(), plain.numpy(), atol=ATOL)


@pytest.mark.parametrize("quant,q_width,block_size", [
    (False, 4, 8), (False, 1, 4), (True, 4, 4)],
    ids=["f32-ragged", "f32-decode", "int8-ragged"])
def test_stats_match_jax_kernel_in_interpret_mode(quant, q_width,
                                                  block_size):
    q, pk, pv, tables, kv_lens, q_lens = _case(
        40 + q_width, block_size=block_size, heads=(4, 2), q_width=q_width)
    decode = q_width == 1
    got = _port(q, _pages(quant, pk, pv, "torch"), tables, kv_lens, q_lens,
                0, decode)
    want = _jax(q, _pages(quant, pk, pv, "jax"), tables, kv_lens, q_lens, 0,
                decode, backend="pallas", interpret=True)
    _assert_close(got, want)


def test_bf16_pages_stats_match_jax_f32_reference():
    q, pk, pv, tables, kv_lens, q_lens = _case(5, block_size=8,
                                               heads=(4, 2), q_width=4)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, pk, pv))
    out, m, l = tpa.paged_attention(  # noqa: E741
        tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(kv_lens),
        q_lens=torch.from_numpy(q_lens), layer=1, return_stats=True)
    assert out.dtype == torch.bfloat16 and m.dtype == l.dtype == torch.float32
    jout, jm, jl = jpa.paged_attention(
        *[jnp.asarray(x.float().numpy()) for x in (tq, tk, tv)],
        jnp.asarray(tables), jnp.asarray(kv_lens),
        q_lens=jnp.asarray(q_lens), layer=1, backend="xla",
        return_stats=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout),
                               atol=1.5e-2, rtol=0)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=STAT_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=STAT_RTOL)


def _split(tables, n):
    pos = np.arange(tables.shape[1])
    return [np.where(pos % n == s, tables, -1).astype(np.int32)
            for s in range(n)]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_round_robin_split_and_merge_equals_unsharded(shards, quant):
    q, pk, pv, tables, kv_lens, q_lens = _case(
        60 + shards, block_size=4, heads=(4, 2), q_width=4,
        blocks_per_row=8, num_blocks=50)
    pages = _pages(quant, pk, pv, "torch")
    parts = [_port(q, pages, t, kv_lens, q_lens, 1, False)
             for t in _split(tables, shards)]
    merged = merge_shards(*zip(*parts))
    whole = tpa.paged_attention(
        torch.from_numpy(q), *pages, torch.from_numpy(tables),
        torch.from_numpy(kv_lens), q_lens=torch.from_numpy(q_lens), layer=1)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), atol=ATOL,
                               rtol=0)
    # each row's stats merge to the unsharded row's
    _, m, l = _port(q, pages, tables, kv_lens, q_lens, 1, False)  # noqa
    m_all = torch.stack([p[1] for p in parts]).amax(0)
    l_all = sum(p[2] * torch.exp(p[1] - m_all) for p in parts)
    np.testing.assert_allclose(m_all.numpy(), m.numpy(), rtol=1e-6)
    np.testing.assert_allclose(l_all.numpy(), l.numpy(), rtol=1e-5)


def test_stats_launch_nothing_on_the_cpu():
    q, pk, pv, tables, kv_lens, q_lens = _case(1, block_size=4,
                                               heads=(4, 4), q_width=4)
    counts = (tpa.paged_attention.stats_launches,
              tpa.paged_attention.int8_stats_launches)
    out = _port(q, _pages(True, pk, pv, "torch"), tables, kv_lens, q_lens,
                0, False)
    assert len(out) == 3
    assert counts == (tpa.paged_attention.stats_launches,
                      tpa.paged_attention.int8_stats_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 3, 8],
                         ids=["rule", "split3", "split8"])
@pytest.mark.parametrize("quant", [False, True], ids=["pages", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_stats_kernel_matches_plain_on_card(quant, dtype, head_dim, splits,
                                            monkeypatch):
    """Split cases: the merged (m, l) of 3 and 8 blocks a row, with a
    kv_len-0 row, a row of only holes and a hole in the full row."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    force_splits(monkeypatch, splits)
    dt = getattr(torch, dtype)
    q, pk, pv, tables, kv_lens, q_lens = _case(
        2, block_size=16, heads=(4, 2), q_width=8, blocks_per_row=8,
        num_blocks=48, head_dim=head_dim)
    pages = tuple(p.cuda() if not quant else tpa.QuantPages(*(
        x.cuda() for x in p)) for p in _pages(quant, pk, pv, "torch"))
    if not quant:
        pages = tuple(p.to(dt) for p in pages)
    tq = torch.from_numpy(q).cuda().to(dt)
    rest = [torch.from_numpy(x).cuda() for x in (tables, kv_lens, q_lens)]
    counter = "int8_stats_launches" if quant else "stats_launches"
    before = getattr(tpa.paged_attention, counter)
    out, m, l = tpa.paged_attention(tq, *pages, *rest[:2], q_lens=rest[2],  # noqa: E741
                                    layer=1, return_stats=True)
    torch.cuda.synchronize()
    assert getattr(tpa.paged_attention, counter) == before + 1
    ref, m_ref, l_ref = tpa.paged_attention_reference(
        tq, *pages, *rest[:2], q_lens=rest[2], layer=1, return_stats=True)
    # out within atol + rtol (|ref| + p.|v|), K1's bound (chip_smoke's
    # TOLERANCE); m and l as chip_smoke's STATS_M_TOL / STATS_L_TOL state
    v = pages[1]
    abs_v = tpa.QuantPages(v.data.abs(), v.scale) if quant else v.abs()
    ref_abs_v = tpa.paged_attention_reference(
        tq, pages[0], abs_v, *rest[:2], q_lens=rest[2], layer=1).float()
    atol, rtol = (1e-5, 1e-5) if dtype == "float32" else (1e-4, 2 ** -7)
    assert ((out.float() - ref.float()).abs()
            <= atol + rtol * (ref.float().abs() + ref_abs_v)).all()
    live = l_ref > 0
    assert ((m - m_ref).abs()[live] <= 1e-5 * (1 + m_ref.abs()[live])).all()
    assert ((l - l_ref).abs()[live] <= 1e-4 * l_ref[live]).all()
    assert (m[~live] == NEG_INF).all() and (l[~live] == 0).all()
