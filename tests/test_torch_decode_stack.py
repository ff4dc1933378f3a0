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


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_one_layer_matches_plain_on_card(small, dtype):
    """K8 on the tiny stacks, one layer at a time (where a moved code
    cannot cascade through later layers), against the plain version:
    within 1e-5 max|plain| plus 16 code steps (chip_smoke.py's
    per-layer limit, DECODE_FLIP_STEPS)."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    _, _, _, stacks = small
    x, kc, vc = (torch.from_numpy(a).cuda() for a in _inputs(2))
    stacks = {k: v.cuda() for k, v in stacks.items()}
    tdtype = getattr(torch, dtype)
    kc, vc = kc.to(tdtype), vc.to(tdtype)
    h = x
    for layer in range(SMALL["num_layers"]):
        one = {k: v[layer:layer + 1] for k, v in stacks.items()}
        kr, vr = kc[layer:layer + 1].clone(), vc[layer:layer + 1].clone()
        steps = {}
        ref, _, _ = ds.fused_decode_stack_reference(
            h, 8, kr, vr, one, num_heads=4, chunks=2, code_steps=steps)
        before = ds.fused_decode_stack.launches
        h, _, _ = ds.fused_decode_stack(h, 8, kc[layer:layer + 1],
                                        vc[layer:layer + 1], one,
                                        num_heads=4, chunks=2)
        torch.cuda.synchronize()
        assert ds.fused_decode_stack.launches == before + 1
        lim = 1e-5 * ref.abs().max() + 16 * max(steps["out"] + steps["proj"])
        assert ((h - ref).abs() <= lim).all()
