"""Port parity: the fused decode-stack kernel's module (K8,
``tnn_tpu_torch/ops/decode_stack.py``).

On the tiny GPT-2 of ``tests/test_fused_decode.py`` (2L/256d/4h, F 1024,
vocab 512; every matmul quantizes), B=2, T=32, the port's plain
``fused_decode_stack`` against JAX's ``fused_decode_stack(...,
interpret=True)`` on the same x, caches and int8 stacks, under FP32 and
with bf16 x and caches, at t in {0, 8, 31} and 1, 2 or 4 MLP chunks.

Both compute in f32 at the same rounding points and differ by summation
order and by XLA's rsqrt / tanh against torch's: about 1e-7 of max|x_out|
(reading: 6e-8 to 2.5e-7). Such a difference can tip a re-quantized
activation at a tie to its other int8 neighbour; every such code moves the
outputs of its matmul by at most one code step times the largest weight it
meets (U, the plain version's ``code_steps``). The test records every code
both sides quantize (JAX's through ``jax.debug.callback`` on a
monkeypatched ``_quant_rows``) and reports how many differ. Reading: none
of 18 cases has a differing code. So the limit is
    |port - jax| <= 1e-5 max|jax| + n_diff * U + (bf16) 2^-8 |jax|,
n_diff the codes that differ (0 in the reading, so the float term alone
holds) and the last term one rounding of a bf16 output; n_diff must stay
at most 2 per case. Rows < t of both caches are bit for bit unchanged and
rows > t untouched.

The plain version against the port's own unfused w8a8 step
(``apply_cached`` on the quantized copy): logits within JAX's bound for
its kernel, rel < 0.05 (``tests/test_fused_decode.py:62-63``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tnn_tpu.ops.pallas.decode_stack as jds
from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.fused_decode import stack_decode_weights as jstack
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.nn.quant import quantize_for_decode as jquant
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.fused_decode import (caches_to_stacked,
                                               stack_decode_weights)
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.nn.quant import quantize_for_decode
from tnn_tpu_torch.ops import decode_stack as ds

SMALL = dict(vocab_size=512, max_len=64, num_layers=2, d_model=256,
             num_heads=4)
B, T = 2, 32
MAX_DIFFERING_CODES = 2


@pytest.fixture(scope="module")
def small():
    jm = JGPT2(**SMALL, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (2, 16))["params"]
    tm = GPT2(**SMALL, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    qm = quantize_for_decode(tm)
    return jm, jstack(jm, jquant(params)), qm, stack_decode_weights(qm)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, SMALL["d_model"])).astype(np.float32)
    shape = (SMALL["num_layers"], B, T, SMALL["d_model"])
    kc = (rng.normal(size=shape) * 0.5).astype(np.float32)
    vc = (rng.normal(size=shape) * 0.5).astype(np.float32)
    return x, kc, vc


def _recorded_codes(monkeypatch):
    """Record every code array both sides quantize, in JAX's order: per
    layer ln1, ctx, then (ln2, gelu chunk c) per chunk (the TPU kernel
    re-quantizes ln2 in every chunk step; the port once)."""
    jcodes, tcodes = [], []
    jorig, torig = jds._quant_rows, ds._quant_rows

    def jrec(x):
        xi, sx = jorig(x)
        jax.debug.callback(lambda a: jcodes.append(np.asarray(a)), xi)
        return xi, sx

    def trec(x):
        codes, sx = torig(x)
        tcodes.append(codes.numpy().astype(np.int8))
        return codes, sx

    monkeypatch.setattr(jds, "_quant_rows", jrec)
    monkeypatch.setattr(ds, "_quant_rows", trec)
    jds.fused_decode_stack.clear_cache()     # retrace with the recorder
    return jcodes, tcodes


def _jax_order(tcodes, chunks):
    out = []
    per = 3 + chunks
    for i in range(0, len(tcodes), per):
        ln1, ctx, ln2, *gs = tcodes[i:i + per]
        out += [ln1, ctx] + [c for g in gs for c in (ln2, g)]
    return out


@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("t", [0, 8, 31])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(small, monkeypatch, dtype, t, chunks):
    _, jstacks, _, tstacks = small
    x, kc, vc = _inputs(100 * t + chunks)
    jcodes, tcodes = _recorded_codes(monkeypatch)
    jdtype, tdtype = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jkc, jvc = jds.fused_decode_stack(
        jnp.asarray(x, jdtype), jnp.int32(t), jnp.asarray(kc, jdtype),
        jnp.asarray(vc, jdtype), jstacks, num_heads=SMALL["num_heads"],
        chunks=chunks, interpret=True)
    jx = np.asarray(jx.astype(jnp.float32))
    jax.effects_barrier()
    k_in = torch.from_numpy(kc).to(tdtype)
    v_in = torch.from_numpy(vc).to(tdtype)
    tkc, tvc = k_in.clone(), v_in.clone()
    steps = {}
    tx, tkc2, tvc2 = ds.fused_decode_stack_reference(
        torch.from_numpy(x).to(tdtype), t, tkc, tvc, tstacks,
        num_heads=SMALL["num_heads"], chunks=chunks, code_steps=steps)
    assert tkc2 is tkc and tvc2 is tvc       # in place
    tcodes = _jax_order(tcodes, chunks)
    assert len(tcodes) == len(jcodes)
    n_diff = sum(int((a != b).sum()) for a, b in zip(tcodes, jcodes))
    n_codes = sum(a.size for a in tcodes)
    print(f"{dtype} t={t} chunks={chunks}: {n_diff} of {n_codes} codes "
          "differ")
    assert n_diff <= MAX_DIFFERING_CODES

    cast = 2 ** -8 if dtype == "bfloat16" else 0.0
    tx = tx.float().numpy()
    u_res = max(steps["out"] + steps["proj"])
    lim = 1e-5 * np.abs(jx).max() + n_diff * u_res + cast * np.abs(jx)
    assert (np.abs(tx - jx) <= lim).all(), np.abs(tx - jx).max()
    for got, want, before in ((tkc, jkc, k_in), (tvc, jvc, v_in)):
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        row, ref = got[:, :, t], want[:, :, t]
        lim = 1e-5 * np.abs(ref).max() + n_diff * max(steps["qkv"]) \
            + cast * np.abs(ref)
        assert (np.abs(row - ref) <= lim).all(), np.abs(row - ref).max()
        before = before.float().numpy()
        np.testing.assert_array_equal(got[:, :, :t], before[:, :, :t])
        np.testing.assert_array_equal(got[:, :, t + 1:], before[:, :, t + 1:])


@pytest.mark.parametrize("chunks", [1, 2])
def test_plain_matches_unfused_w8a8_step(small, chunks):
    """The fused step (mirroring fused_generate's body) against the
    model's own unfused int8 step on the same prefilled caches."""
    _, _, qm, stacks = small
    rs = np.random.RandomState(0)
    p = 8
    prompt = torch.from_numpy(rs.randint(0, 512, (B, p)))
    tok = torch.from_numpy(rs.randint(0, 512, (B,)))
    with torch.inference_mode():
        caches = qm.init_cache(B, T)
        qm.apply_cached(prompt, caches, 0)
        kc, vc = caches_to_stacked(caches)
        want = qm.apply_cached(tok[:, None], caches, p)[:, -1]
        x = qm.wpe(qm.wte(tok[:, None]), offset=p)[:, 0]
        x_out, kc, vc = ds.fused_decode_stack(
            x, p, kc, vc, stacks, num_heads=SMALL["num_heads"],
            chunks=chunks)
        got = qm._head(x_out[:, None, :])[:, -1]
    rel = (got - want).abs().max() / want.abs().max()
    assert rel < 0.05, rel
    k_want, v_want = caches_to_stacked(caches)
    for g, w in ((kc, k_want), (vc, v_want)):
        row_err = (g[:, :, p] - w[:, :, p]).abs().max() \
            / (w[:, :, p].abs().max() + 1e-9)
        assert row_err < 0.05, row_err
        assert torch.equal(g[:, :, :p], w[:, :, :p])
        assert not g[:, :, p + 1:].any()


def test_wrapper_checks_and_cpu_path_counts_nothing(small):
    _, _, _, stacks = small
    x, kc, vc = (torch.from_numpy(a) for a in _inputs(1))
    before = ds.fused_decode_stack.launches
    out, _, _ = ds.fused_decode_stack(x, 3, kc, vc, stacks, num_heads=4,
                                      chunks=2)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert ds.fused_decode_stack.launches == before
    with pytest.raises(ValueError, match="outside the cache"):
        ds.fused_decode_stack(x, T, kc, vc, stacks, num_heads=4, chunks=2)
    with pytest.raises(ValueError, match="chunks"):
        ds.fused_decode_stack(x, 0, kc, vc, stacks, num_heads=4, chunks=3)
    with pytest.raises(ValueError, match="stacks"):
        ds.fused_decode_stack(x, 0, kc, vc, {**stacks, "fc_q": stacks[
            "fc_q"].float()}, num_heads=4, chunks=2)
    with pytest.raises(ValueError, match="caches"):
        ds.fused_decode_stack(x[:1], 0, kc, vc, stacks, num_heads=4,
                              chunks=2)


def test_stamps_are_the_kernel_clock(small):
    _, _, _, stacks = small
    x, kc, vc = (torch.from_numpy(a) for a in _inputs(1))
    with pytest.raises(ValueError, match="stamps"):
        ds.fused_decode_stack(x, 3, kc, vc, stacks, num_heads=4, chunks=2,
                              stamps=torch.zeros(16, dtype=torch.int64))


# -- the launch plan: shapes only ---------------------------------------------

GPT2_SMALL = dict(d_model=768, d_ff=3072, heads=12)
TINY = dict(d_model=SMALL["d_model"], d_ff=4 * SMALL["d_model"],
            heads=SMALL["num_heads"])


@pytest.mark.parametrize("blocks", [1, 7, 132])
@pytest.mark.parametrize("widths", [GPT2_SMALL, TINY],
                         ids=["gpt2_small", "tiny"])
def test_partition_covers_each_matrix_once_in_order(widths, blocks):
    """Each block owns one contiguous range of every matrix's output rows
    (so its share of a phase is one byte range of the stack); the ranges
    follow block order and cover each row once; each ring stage holds
    whole rows within STAGE_BYTES."""
    shapes = ds.matrix_shapes(widths["d_model"], widths["d_ff"])
    share = [0] * blocks
    for n_rows, row_bytes in shapes.values():
        ranges = ds.plan_partition(n_rows, blocks)
        assert len(ranges) == blocks
        assert ranges[0][0] == 0 and ranges[-1][1] == n_rows
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
        assert [r for r0, r1 in ranges for r in range(r0, r1)] \
            == list(range(n_rows))
        sizes = [r1 - r0 for r0, r1 in ranges]
        assert max(sizes) - min(sizes) <= 1
        for i, (r0, r1) in enumerate(ranges):
            share[i] += (r1 - r0) * row_bytes
            stages, rps = ds.plan_stages(r1 - r0, row_bytes)
            assert (stages - 1) * rps < r1 - r0 <= stages * rps
            assert rps * row_bytes <= ds.STAGE_BYTES
    d = widths["d_model"]
    assert sum(share) == 4 * d * d + 2 * widths["d_ff"] * d
    if widths is GPT2_SMALL and blocks == 132:   # 53.6 KB a layer
        assert round(sum(share) / blocks) == 53_620
        assert max(share) - min(share) <= 3 * d + widths["d_ff"]


def test_split_plan_reads_shapes_only():
    """Attention's split count comes from (B, H, t, blocks), host ints, so
    the launch needs no sync: at most one split per MIN_SPLIT_LEN
    positions and B H S <= blocks items, none empty, none past
    MAX_SPLIT_LEN."""
    import inspect

    assert list(inspect.signature(ds.plan_splits).parameters) == [
        "batch", "heads", "t", "blocks"]
    assert ds.plan_splits(1, 12, 1023, 132) == (11, 94)
    assert ds.plan_splits(2, 12, 1023, 132) == (5, 205)
    assert ds.plan_splits(16, 12, 1023, 132) == (1, 1024)
    assert ds.plan_splits(1, 12, 0, 132) == (1, 1)
    assert ds.plan_splits(np.int64(1), np.int64(12), np.int64(1023),
                          np.int64(132)) == (11, 94)
    for batch in (1, 2, 16):
        for heads in (4, 12):
            for t in (0, 1, 63, 64, 127, 511, 1023, 4095):
                for blocks in (1, 7, 132):
                    s, pps = ds.plan_splits(batch, heads, t, blocks)
                    n = t + 1
                    assert (s - 1) * pps < n <= s * pps
                    assert pps <= ds.MAX_SPLIT_LEN and s <= ds.MAX_SPLITS
                    if pps < n:      # split: by the blocks or the smem cap
                        assert (batch * heads * s <= blocks
                                and s <= -(-n // ds.MIN_SPLIT_LEN)
                                or s == -(-n // ds.MAX_SPLIT_LEN))


@pytest.mark.parametrize("chunks", [1, 2, 4, 8])
def test_barriers_per_step_five_a_layer(chunks):
    for n_layers in (1, 2, 12, 24):
        assert ds.barriers_per_step(n_layers, chunks) == 5 * n_layers - 1
    assert ds.barriers_per_step(12, chunks) == 59


@pytest.mark.parametrize("batch", [1, 2, 16])
def test_smem_rule_matches_check_kernel_geometry(batch):
    """The block's shared memory is the fixed layout plus as many 24 KB
    ring stages as fit (at least 2), whatever the cache length; the hand
    counts below follow csrc/decode_stack.cu's plan_layout."""
    bf16 = torch.bfloat16
    for chunks in (1, 2, 4, 8):
        for w in (GPT2_SMALL, TINY):
            dh = w["d_model"] // w["heads"]
            fixed = ds._smem_bytes(batch, w["d_model"], w["d_ff"], chunks,
                                   dh, 132)
            smem = ds.check_kernel_geometry(batch, w["d_model"], w["d_ff"],
                                            chunks, dh, bf16, blocks=132)
            ring = ds.ring_stages(smem, fixed)
            assert smem == fixed + ring * ds.STAGE_BYTES <= 227 * 1024
            assert ds.MIN_RING_STAGES <= ring <= ds.MAX_RING_STAGES
            assert smem == ds.check_kernel_geometry(
                batch, w["d_model"], w["d_ff"], chunks, dh, torch.float32,
                blocks=132)
    # gpt2_small on 132 blocks: bars 256, codes 768 B, union 8192 (an
    # attention split's scores and p @ V partials), LN vectors 6144, two
    # vector buffers 576, residual 32, sums 96, small 2048 = 18112, then 8
    # stages; at 16 rows and 8 chunks 73920 and 6
    hand = {1: (2, 18112, 8), 16: (8, 73920, 6)}
    if batch in hand:
        chunks, fixed, ring = hand[batch]
        assert ds._smem_bytes(batch, 768, 3072, chunks, 64, 132) == fixed
        assert ds.check_kernel_geometry(batch, 768, 3072, chunks, 64, bf16) \
            == fixed + ring * ds.STAGE_BYTES


# -- on the card --------------------------------------------------------------

CARD_T = 256
# t at split edges (MIN_SPLIT_LEN = 64 positions) and the cache's end
CARD_TS = (0, 63, 64, CARD_T - 1)
FORCED_SPLITS = (2, 3, 7)


def _card_inputs(seed, batch, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, SMALL["d_model"])).astype(np.float32)
    shape = (SMALL["num_layers"], batch, CARD_T, SMALL["d_model"])
    kc = (rng.normal(size=shape) * 0.5).astype(np.float32)
    vc = (rng.normal(size=shape) * 0.5).astype(np.float32)
    return (torch.from_numpy(a).cuda().to(dtype) for a in (x, kc, vc))


def _card_case(stacks, x, t, kc, vc, chunks):
    """The L-layer launch (one launch, its repeat bit for bit, the other
    cache rows untouched) against the chain of one-layer launches (bit
    for bit), and each layer against the plain version: within 1e-5
    max|plain| plus 16 code steps (chip_smoke.py's per-layer limit,
    DECODE_FLIP_STEPS), row t of both caches likewise (plus one bf16
    rounding)."""
    k0, v0 = kc.clone(), vc.clone()
    before = ds.fused_decode_stack.launches
    out, kc, vc = ds.fused_decode_stack(x, t, kc, vc, stacks, num_heads=4,
                                        chunks=chunks)
    torch.cuda.synchronize()
    assert ds.fused_decode_stack.launches == before + 1
    for got, want in ((kc, k0), (vc, v0)):
        assert torch.equal(got[:, :, :t], want[:, :, :t])
        assert torch.equal(got[:, :, t + 1:], want[:, :, t + 1:])
    k2, v2 = k0.clone(), v0.clone()
    again, k2, v2 = ds.fused_decode_stack(x, t, k2, v2, stacks, num_heads=4,
                                          chunks=chunks)
    assert torch.equal(again, out) and torch.equal(k2, kc) \
        and torch.equal(v2, vc)
    cast = 2 ** -8 if kc.dtype == torch.bfloat16 else 0.0
    h = x.float()
    kch, vch = k0.clone(), v0.clone()
    for layer in range(SMALL["num_layers"]):
        one = {k: v[layer:layer + 1] for k, v in stacks.items()}
        kr, vr = k0[layer:layer + 1].clone(), v0[layer:layer + 1].clone()
        steps = {}
        ref, kr, vr = ds.fused_decode_stack_reference(
            h, t, kr, vr, one, num_heads=4, chunks=chunks, code_steps=steps)
        h, _, _ = ds.fused_decode_stack(h, t, kch[layer:layer + 1],
                                        vch[layer:layer + 1], one,
                                        num_heads=4, chunks=chunks)
        lim = 1e-5 * ref.abs().max() + 16 * max(steps["out"] + steps["proj"])
        assert ((h - ref).abs() <= lim).all(), (h - ref).abs().max()
        for got, want in ((kch, kr), (vch, vr)):
            g, w = got[layer, :, t].float(), want[0, :, t].float()
            lim = 1e-5 * w.abs().max() + cast * w.abs() \
                + 16 * max(steps["qkv"])
            assert ((g - w).abs() <= lim).all(), (g - w).abs().max()
    torch.cuda.synchronize()
    assert torch.equal(h.to(out.dtype), out)
    assert torch.equal(kch, kc) and torch.equal(vch, vc)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 16])
@pytest.mark.parametrize("chunks", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_one_layer_matches_plain_on_card(small, monkeypatch, dtype,
                                                chunks, batch):
    """K8 on the tiny stacks (T = 256), one layer at a time (where a moved
    code cannot cascade through later layers) against the plain version,
    at t on the split rule's edges and with the split count forced to 2,
    3 and 7 (a monkeypatch of ``plan_splits``, as ``force_splits`` does
    for K1); each case also repeats bit for bit and equals the chain of
    one-layer launches bit for bit (``_card_case``)."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    _, _, _, stacks = small
    stacks = {k: v.cuda() for k, v in stacks.items()}
    tdtype = getattr(torch, dtype)
    for i, t in enumerate(CARD_TS):
        x, kc, vc = _card_inputs(10 * i + chunks, batch, tdtype)
        _card_case(stacks, x, t, kc, vc, chunks)
    rule = ds.plan_splits
    t = CARD_T - 1
    for s in FORCED_SPLITS:
        monkeypatch.setattr(ds, "plan_splits",
                            lambda b, h, t, n, s=s: (s, -(-(t + 1) // s)))
        x, kc, vc = _card_inputs(100 + s, batch, tdtype)
        _card_case(stacks, x, t, kc, vc, chunks)
    monkeypatch.setattr(ds, "plan_splits", rule)


@pytest.mark.cuda
def test_kernel_plan_and_counters_on_card(small):
    """The kernel's own shared-memory plan equals this module's mirror at
    the GPT-2 small and tiny widths; after launches with split attention
    the zeroed counters are all 0 again (the barrier's reset by the last
    block out, the splits' by their mergers); stamps rise through the
    5 L - 1 barriers and cost the output nothing."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    from tnn_tpu_torch.ops import runtime

    blocks = runtime.sm_count("cuda")
    for batch in (1, 2, 16):
        for chunks in (1, 2, 4, 8):
            for w in (GPT2_SMALL, TINY):
                dh = w["d_model"] // w["heads"]
                smem = ds.check_kernel_geometry(
                    batch, w["d_model"], w["d_ff"], chunks, dh,
                    torch.bfloat16, blocks=blocks)
                fixed = ds._smem_bytes(batch, w["d_model"], w["d_ff"],
                                       chunks, dh, blocks)
                assert ds.kernel_plan(batch, w["d_model"], w["d_ff"], chunks,
                                      w["heads"], blocks, smem) == {
                    "fixed": fixed, "ring": ds.ring_stages(smem, fixed)}
    _, _, _, stacks = small
    stacks = {k: v.cuda() for k, v in stacks.items()}
    x, kc, vc = _card_inputs(5, 1, torch.bfloat16)
    assert ds.plan_splits(1, 4, CARD_T - 1, blocks)[0] > 1
    out, _, _ = ds.fused_decode_stack(x, CARD_T - 1, kc.clone(), vc.clone(),
                                      stacks, num_heads=4, chunks=2)
    n_bar = ds.barriers_per_step(SMALL["num_layers"], 2)
    stamps = torch.zeros(n_bar + 2, dtype=torch.int64, device="cuda")
    again, _, _ = ds.fused_decode_stack(x, CARD_T - 1, kc.clone(), vc.clone(),
                                        stacks, num_heads=4, chunks=2,
                                        stamps=stamps)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert (stamps.diff() >= 0).all() and stamps[0] > 0
    counters = runtime.zeroed_counters("decode_stack", "cuda", 1)
    assert not counters.any()
