"""Port parity: ragged paged attention and its write half.

The port's plain PyTorch version (what the kernel wrapper computes on CPU
tensors) is held against the JAX package's Pallas kernel run in interpret
mode and against its XLA reference, on the same numpy-seeded inputs. The
CUDA kernel itself runs only on the card: ``test_kernel_matches_plain_on_card``
carries the ``cuda`` marker and skips here. The split-KV rule, which
decides from shapes alone how many blocks share a row's table, is checked
here: its ranges cover the table, and the plain version's partials over
them merge to the whole row.

Tolerance: both sides compute in float32 on the CPU and differ only in
summation order, so outputs agree to 2e-5 absolute on O(1) values.
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu.ops.pallas import paged_attention as jpa
from tnn_tpu_torch.ops import paged_attention as tpa
from tnn_tpu_torch.ops.softmax_merge import merge_shards

ATOL = 2e-5


def _case(seed, *, block_size, heads, q_width, batch=4, num_layers=2,
          num_blocks=24, head_dim=16, blocks_per_row=4, holes=False):
    """Pool pages, block tables and ragged lengths: one zero-length row,
    one full row, one short row; scratch-padded tails; optional -1 holes."""
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
        tables[1, 1] = -1
    q = rng.normal(size=(batch, q_width, h, head_dim)).astype(np.float32)
    return q, pk, pv, tables, kv_lens, q_lens


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("q_width", [1, 4, 8])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)],
                         ids=["mha", "gqa2", "mqa"])
@pytest.mark.parametrize("block_size", [4, 8])
def test_plain_matches_jax_kernel_and_reference(block_size, heads, q_width):
    q, pk, pv, tables, kv_lens, q_lens = _case(
        block_size + 10 * q_width + heads[1], block_size=block_size,
        heads=heads, q_width=q_width)
    jargs = [jnp.asarray(a) for a in (q, pk, pv, tables, kv_lens)]
    kernel = np.asarray(jpa.paged_attention(
        *jargs, q_lens=jnp.asarray(q_lens), layer=1, backend="pallas",
        interpret=True))
    ref = np.asarray(jpa.paged_attention_reference(
        *jargs, q_lens=jnp.asarray(q_lens), layer=1))
    tq, tk, tv, tt, tl, tql = _torch(q, pk, pv, tables, kv_lens, q_lens)
    out = tpa.paged_attention(tq, tk, tv, tt, tl, q_lens=tql, layer=1)
    plain = tpa.paged_attention_reference(tq, tk, tv, tt, tl, q_lens=tql,
                                          layer=1)
    np.testing.assert_allclose(out.numpy(), kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    assert torch.equal(out, plain)


@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa2"])
def test_decode_form_matches_jax(heads):
    q, pk, pv, tables, kv_lens, _ = _case(3, block_size=8, heads=heads,
                                          q_width=1)
    jout = np.asarray(jpa.paged_attention(
        jnp.asarray(q[:, 0]), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(kv_lens), layer=0,
        backend="pallas", interpret=True))
    tq, tk, tv, tt, tl = _torch(q[:, 0], pk, pv, tables, kv_lens)
    out = tpa.paged_attention(tq, tk, tv, tt, tl, layer=0)
    assert out.shape == tq.shape
    np.testing.assert_allclose(out.numpy(), jout, atol=ATOL, rtol=0)
    assert not out[0].any()   # kv_len 0: exactly zero


def test_holes_and_dead_rows_match_jax_and_output_zero():
    q, pk, pv, tables, kv_lens, q_lens = _case(
        11, block_size=4, heads=(4, 2), q_width=4, holes=True)
    jout = np.asarray(jpa.paged_attention(
        *[jnp.asarray(a) for a in (q, pk, pv, tables, kv_lens)],
        q_lens=jnp.asarray(q_lens), layer=1, backend="pallas",
        interpret=True))
    tq, tk, tv, tt, tl, tql = _torch(q, pk, pv, tables, kv_lens, q_lens)
    out = tpa.paged_attention(tq, tk, tv, tt, tl, q_lens=tql, layer=1)
    np.testing.assert_allclose(out.numpy(), jout, atol=ATOL, rtol=0)
    for i, n in enumerate(q_lens):
        assert not out[i, n:].any()   # padding tokens output exactly 0
    assert not out[0].any()


def test_bf16_pages_match_jax_f32_reference():
    """bf16 q/pages against the JAX reference in f32 on the same bf16-rounded
    inputs (not every XLA:CPU build runs a bf16 x bf16 -> f32 dot). The
    port rounds p to bf16 before PV and the output to bf16: 2**-8 relative
    each on outputs of magnitude < 2, so 1.5e-2 absolute."""
    q, pk, pv, tables, kv_lens, q_lens = _case(5, block_size=8,
                                               heads=(4, 2), q_width=4)
    tq, tk, tv, tt, tl, tql = _torch(q, pk, pv, tables, kv_lens, q_lens)
    tq, tk, tv = tq.bfloat16(), tk.bfloat16(), tv.bfloat16()
    ref = np.asarray(jpa.paged_attention_reference(
        *[jnp.asarray(x.float().numpy()) for x in (tq, tk, tv)],
        jnp.asarray(tables), jnp.asarray(kv_lens),
        q_lens=jnp.asarray(q_lens), layer=1))
    out = tpa.paged_attention(tq, tk, tv, tt, tl, q_lens=tql, layer=1)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1.5e-2,
                               rtol=0)


def test_scatter_rows_and_chunk_match_jax_with_scratch_redirect():
    rng = np.random.default_rng(7)
    shape = (2, 10, 2, 4, 8)
    pages = rng.normal(size=shape).astype(np.float32)
    tables = np.array([[3, 5, 0], [7, -1, 2], [0, 0, 0]], np.int32)
    offsets = np.array([5, 4, 3], np.int32)            # row 1 hits the hole
    rows = rng.normal(size=(3, 2, 8)).astype(np.float32)
    jout = np.asarray(jpa.scatter_kv_rows(
        jnp.asarray(pages), jnp.asarray(tables), jnp.asarray(offsets),
        jnp.asarray(rows), layer=1))
    tpages = torch.from_numpy(pages.copy())
    ret = tpa.scatter_kv_rows(tpages, *_torch(tables, offsets, rows),
                              layer=1)
    assert ret is tpages                               # updated in place
    np.testing.assert_array_equal(tpages.numpy(), jout)
    np.testing.assert_array_equal(tpages[1, 0, :, 0].numpy(), rows[1])

    starts = np.array([2, 0, 9], np.int32)
    q_lens = np.array([5, 3, 0], np.int32)             # row 2 is dead
    chunk = rng.normal(size=(3, 6, 2, 8)).astype(np.float32)
    jout = np.asarray(jpa.scatter_kv_chunk(
        jnp.asarray(pages), jnp.asarray(tables), jnp.asarray(starts),
        jnp.asarray(chunk), jnp.asarray(q_lens), layer=0))
    tpages = torch.from_numpy(pages.copy())
    tpa.scatter_kv_chunk(tpages, *_torch(tables, starts, chunk, q_lens),
                         layer=0)
    live = [b for b in range(10) if b != 0]
    # live blocks match exactly; which padding token wins a scratch slot is
    # unspecified on both sides
    np.testing.assert_array_equal(tpages.numpy()[:, live], jout[:, live])
    np.testing.assert_array_equal(tpages.numpy()[1], pages[1])
    for t in range(5):   # row 0's live tokens land through its table
        pos = 2 + t
        blk = tables[0, pos // 4]
        np.testing.assert_array_equal(tpages[0, blk, :, pos % 4].numpy(),
                                      chunk[0, t])


def test_round_trip_scatter_then_attend_matches_dense():
    """Scatter a chunk, then attend: equals dense causal attention."""
    rng = np.random.default_rng(9)
    bs, hkv, h, dh, qw = 4, 2, 4, 8, 6
    pages = torch.zeros((1, 6, hkv, bs, dh))
    tables = torch.tensor([[2, 4]], dtype=torch.int32)
    k = torch.from_numpy(rng.normal(size=(1, qw, hkv, dh)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, qw, hkv, dh)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(1, qw, h, dh)).astype(np.float32))
    starts = torch.zeros(1, dtype=torch.int32)
    q_lens = torch.full((1,), qw, dtype=torch.int32)
    pk, pv = pages.clone(), pages.clone()
    tpa.scatter_kv_chunk(pk, tables, starts, k, q_lens, layer=0)
    tpa.scatter_kv_chunk(pv, tables, starts, v, q_lens, layer=0)
    out = tpa.paged_attention(q, pk, pv, tables, starts + q_lens,
                              q_lens=q_lens, layer=0)
    kk = k.repeat_interleave(2, dim=2).transpose(1, 2)
    vv = v.repeat_interleave(2, dim=2).transpose(1, 2)
    mask = torch.ones(qw, qw, dtype=torch.bool).tril()
    dense = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), kk, vv, attn_mask=mask).transpose(1, 2)
    torch.testing.assert_close(out, dense, atol=ATOL, rtol=0)


def test_cpu_wrapper_runs_plain_version_and_counts_no_launch():
    q, pk, pv, tables, kv_lens, q_lens = _case(1, block_size=4,
                                               heads=(4, 4), q_width=4)
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(*_torch(q, pk, pv, tables, kv_lens),
                              q_lens=torch.from_numpy(q_lens), layer=0)
    assert tpa.paged_attention.launches == before
    assert out.shape == q.shape


def test_wrapper_rejects_bad_shapes():
    q, pk, pv, tables, kv_lens, q_lens = _torch(*_case(
        1, block_size=4, heads=(4, 4), q_width=4))
    with pytest.raises(ValueError):
        tpa.paged_attention(q[..., :8], pk, pv, tables, kv_lens,
                            q_lens=q_lens)
    with pytest.raises(ValueError):
        tpa.paged_attention(q[:, 0], pk, pv, tables, kv_lens, q_lens=q_lens)


# -- split-KV -----------------------------------------------------------------

def force_splits(monkeypatch, splits):
    """Make the wrapper split every row's table into ``splits`` ranges
    (None keeps the rule). The paged-stats and int8 serving tests import
    it too."""
    if splits is not None:
        monkeypatch.setattr(tpa, "plan_paged_splits",
                            lambda b, qw, h, hkv, nb, sms=None:
                            (splits, -(-nb // splits)))


@pytest.mark.parametrize("batch,q_width,heads,table_width", [
    (8, 1, (12, 12), 63), (8, 1, (12, 4), 63), (8, 1, (12, 12), 32),
    (8, 64, (12, 12), 63), (1, 1, (12, 12), 2048), (4, 8, (4, 2), 8),
    (8, 1, (12, 12), 0), (3, 16, (4, 1), 1), (4096, 1, (1, 1), 4096)])
def test_split_rule_covers_the_table(batch, q_width, heads, table_width):
    h, hkv = heads
    splits, pps = tpa.plan_paged_splits(batch, q_width, h, hkv, table_width)
    assert (splits, pps) == tpa.plan_paged_splits(batch, q_width, h, hkv,
                                                  table_width)
    assert splits >= 1 and splits * pps >= table_width
    if table_width:
        assert (splits - 1) * pps < table_width     # no empty range
    if splits > 1:
        assert pps >= tpa.MIN_SPLIT_PAGES
    assert batch * splits <= 65535                 # the grid's z limit


def test_split_rule_reads_host_shapes_only():
    # never kv_lens: the launch needs no sync, so a CUDA graph can hold it
    assert list(inspect.signature(tpa.plan_paged_splits).parameters) == [
        "batch", "q_width", "heads", "kv_heads", "table_width", "sms"]
    # the serving decode shape: 96 (row, kv head) blocks, 63-entry tables
    splits, pps = tpa.plan_paged_splits(8, 1, 12, 12, 63)
    assert splits > 1 and 8 * 12 * splits >= 132


@pytest.mark.parametrize("splits", [2, 3, 8])
def test_split_ranges_merge_to_the_whole_row(splits):
    """What the kernel computes with split-KV, in plain PyTorch: each range
    of the table gives a partial (the stats form over a table with -1
    outside the range: empty where the range is all holes or past the live
    length), and merging them in order gives the unsplit attention."""
    q, pk, pv, tables, kv_lens, q_lens = _torch(*_case(
        5, block_size=4, heads=(4, 2), q_width=4, blocks_per_row=8,
        num_blocks=40, holes=True))
    pps = -(-tables.shape[1] // splits)
    cols = torch.arange(tables.shape[1])
    parts = []
    for sp in range(splits):
        inside = (cols >= sp * pps) & (cols < (sp + 1) * pps)
        part = torch.where(inside, tables, -1).contiguous()
        parts.append(tpa.paged_attention(q, pk, pv, part, kv_lens,
                                         q_lens=q_lens, layer=1,
                                         return_stats=True))
    merged = merge_shards(*zip(*parts))
    whole = tpa.paged_attention(q, pk, pv, tables, kv_lens, q_lens=q_lens,
                                layer=1)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), atol=ATOL,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 2, 3, 8],
                         ids=["rule", "split2", "split3", "split8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_kernel_matches_plain_on_card(dtype, head_dim, splits, monkeypatch):
    """Split cases: 8 table entries over 2, 3 or 8 blocks, with a kv_len-0
    row, a full row beside a one-token row, and (at 8 splits) a range that
    is only a -1 hole and ranges past the short rows' live length."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    force_splits(monkeypatch, splits)
    dt = getattr(torch, dtype)
    q, pk, pv, tables, kv_lens, q_lens = [
        x.cuda() for x in _torch(*_case(2, block_size=16, heads=(4, 2),
                                        q_width=8, blocks_per_row=8,
                                        num_blocks=40, head_dim=head_dim,
                                        holes=True))]
    q, pk, pv = q.to(dt), pk.to(dt), pv.to(dt)
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(q, pk, pv, tables, kv_lens, q_lens=q_lens,
                              layer=1)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    plain = tpa.paged_attention_reference(q, pk, pv, tables, kv_lens,
                                          q_lens=q_lens, layer=1)
    # |err| <= atol + rtol (|ref| + p.|v|), as chip_smoke.TOLERANCE states:
    # f32 differs in summation order only; bf16 rounds p and the output
    atol, rtol = (1e-5, 1e-5) if dtype == "float32" else (1e-4, 2 ** -7)
    abs_v = tpa.paged_attention_reference(q, pk, pv.abs(), tables, kv_lens,
                                          q_lens=q_lens, layer=1)
    limit = atol + rtol * (plain.float().abs() + abs_v.float())
    assert ((out.float() - plain.float()).abs() <= limit).all()
    assert (out[0] == 0).all()          # the kv_len-0 row: exactly 0
