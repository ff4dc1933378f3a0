"""Port parity: flash attention (K4 forward, K7 backward) and ``sdpa``.

The port's plain forward, and its backward through the autograd Function
(``flash_attention`` on CPU tensors), against the JAX package's Pallas
``flash_attention`` run in interpret mode with 32-wide blocks and
``jax.vjp``, on the same numpy-seeded inputs: causal and not, GQA,
``kv_offset``, every mask grouping, lengths that are not a block multiple
and a fully masked row.

Tolerances. FP32: both sides compute in float32 and differ in summation
order only: 1e-5 absolute on outputs and gradients of magnitude below 10.
bf16: both sides run on the same bf16 inputs and output gradient, the JAX
kernel with one 64-wide kv block, so that it rounds p at the row's final
maximum as the plain version does (with two 32-wide blocks it rounds p at
its running maximum, which the plain version does not copy). Each of O,
dQ, dK and dV must lie within 2**-12 of the reference in relative L2 norm
and within 2**-7 of its largest element. Readings over the 11 cases: O and
dV bit for bit equal; dQ and dK at most 6.6e-5 relative L2 and 3.2e-4 of
the largest element (a few bf16 roundings flipped by the f32 summation
order). The JAX kernel run in FP32 on the same bf16 values, which is what
a port that skipped the bf16 roundings would give, reads at least 1.67e-3
relative L2 in every case and tensor, 6.8 times the bound; the test
checks that it falls outside. With the suite's XLA flag,
``XLA_FLAGS=--xla_backend_optimization_level=0 python -m
tests.test_torch_flash_attention`` prints these readings.

The CUDA kernels run only on the card: ``test_kernel_matches_plain_on_card``
carries the ``cuda`` marker and skips here; on the card it holds both
bodies (bf16 on the tensor cores, f32 on the SIMT cores) to
``chip_smoke.flash_check``'s limits at the shapes where their tiles break
first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu.nn.attention import local_xla_attention
from tnn_tpu.ops.pallas.flash_attention import flash_attention as jflash
from tnn_tpu_torch.nn.attention import local_attention, sdpa
from tnn_tpu_torch.ops import flash_attention as fa

FP32_ATOL = 1e-5

# (name, B, H, H_kv, Sq, Skv, causal, kv_offset, mask groups)
CASES = [
    ("causal", 2, 2, 2, 64, 64, True, None, None),
    ("noncausal", 2, 2, 2, 64, 64, False, None, None),
    ("gqa", 2, 4, 2, 64, 64, True, None, None),
    ("mqa_ragged", 1, 4, 1, 40, 40, True, None, None),
    ("cross_ragged", 2, 2, 2, 24, 50, False, None, None),
    ("offset_sq1", 2, 2, 2, 1, 64, True, 37, None),
    ("offset_chunk", 2, 4, 2, 16, 64, True, 40, None),
    ("mask_g1", 2, 2, 2, 32, 48, False, None, "1"),
    ("mask_gB", 2, 2, 2, 32, 48, True, None, "B"),
    ("mask_gBH", 2, 2, 2, 32, 48, False, None, "BH"),
    ("mask_gB_offset", 2, 2, 1, 16, 48, True, 20, "B"),
]


def _case(seed, b, h, hkv, sq, skv, d=16, groups=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    g = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    mask = None
    if groups is not None:
        shape = {"1": (1, 1, sq, skv), "B": (b, 1, sq, skv),
                 "BH": (b, h, sq, skv)}[groups]
        mask = rng.random(shape) > 0.3
        mask[0, 0, 3, :] = False                 # a fully masked row
    return q, k, v, g, mask


def _jax(q, k, v, g, mask, causal, off, dtype=jnp.float32, block_k=32):
    def f(q, k, v):
        return jflash(q, k, v, causal, None, 32, block_k, 32, 32,
                      mask=None if mask is None else jnp.asarray(mask),
                      kv_offset=off)

    q, k, v, g = (jnp.asarray(x, dtype) for x in (q, k, v, g))
    out, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *vjp(g))]


def _port(q, k, v, g, mask, causal, off, dtype=torch.float32):
    tq, tk, tv = (torch.tensor(x).to(dtype).requires_grad_() for x in
                  (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal,
                             mask=None if mask is None
                             else torch.tensor(mask), kv_offset=off)
    (out.float() * torch.tensor(g)).sum().backward()
    return [x.detach().float().numpy() for x in
            (out, tq.grad, tk.grad, tv.grad)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_and_grads_match_jax_fp32(case):
    _, b, h, hkv, sq, skv, causal, off, groups = case
    q, k, v, g, mask = _case(len(case[0]), b, h, hkv, sq, skv, groups=groups)
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    ref = _jax(q, k, v, g, mask, causal, off)
    got = _port(q, k, v, g, mask, causal, off)
    for name, a, r in zip(("out", "dq", "dk", "dv"), got, ref):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a, r, atol=FP32_ATOL, rtol=0,
                                   err_msg=name)
    # on CPU tensors the wrappers take the plain versions: no launches
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches) == before


BF16_REL_L2, BF16_REL_MAX = 2 ** -12, 2 ** -7


def _bf16_readings(case):
    """(O, dQ, dK, dV) relative L2 and max-element errors of the port's
    bf16 path against the JAX kernel's, and the relative L2 errors of the
    JAX kernel in FP32 on the same bf16 values."""
    _, b, h, hkv, sq, skv, causal, off, groups = case
    q, k, v, g, mask = _case(7, b, h, hkv, sq, skv, groups=groups)
    q, k, v, g = (torch.tensor(x).bfloat16().float().numpy()
                  for x in (q, k, v, g))
    assert skv <= 64          # one kv block on the JAX side (docstring)
    ref = _jax(q, k, v, g, mask, causal, off, dtype=jnp.bfloat16, block_k=64)
    got = _port(q, k, v, g, mask, causal, off, dtype=torch.bfloat16)
    f32 = _jax(q, k, v, g, mask, causal, off, block_k=64)

    def rel_l2(a, r):
        return np.linalg.norm(a - r) / np.linalg.norm(r)

    return ([rel_l2(a, r) for a, r in zip(got, ref)],
            [np.abs(a - r).max() / np.abs(r).max() for a, r in zip(got, ref)],
            [rel_l2(a, r) for a, r in zip(f32, ref)])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_and_grads_match_jax_bf16(case):
    l2, mx, f32 = _bf16_readings(case)
    for name, a, m, f in zip(("out", "dq", "dk", "dv"), l2, mx, f32):
        assert a <= BF16_REL_L2 and m <= BF16_REL_MAX, (name, a, m)
        assert f > BF16_REL_L2, (name, f)   # the bound rejects FP32 math


def test_fully_masked_row_is_zero_with_infinite_lse_and_zero_grad():
    q, k, v, g, mask = _case(3, 2, 2, 2, 32, 48, groups="B")
    mask[1, 0, 7, :] = False
    tm = fa.norm_mask(torch.tensor(mask), 2, 2, 32, 48)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    out, lse = fa.flash_attention_fwd(tq, tk, tv, mask=tm)
    assert torch.isinf(lse[0, :, 3]).all() and (lse[0, :, 3] > 0).all()
    assert torch.isinf(lse[1, :, 7]).all()
    assert (out[0, :, 3] == 0).all() and (out[1, :, 7] == 0).all()
    dq, _, _ = fa.flash_attention_bwd(tq, tk, tv, out, lse, torch.tensor(g),
                                      mask=tm)
    assert (dq[0, :, 3] == 0).all() and (dq[1, :, 7] == 0).all()
    assert torch.isfinite(lse[0, :, :3]).all()


def _check_empty_lengths(out, lse, grads, b, h, hkv, sq, skv, d):
    """No key: O = 0 and lse = +inf, so dQ = 0; no q row: dK = dV = 0."""
    assert out.shape == (b, h, sq, d) and lse.shape == (b, h, sq)
    assert (out == 0).all() and torch.isinf(lse).all() and (lse > 0).all()
    dq, dk, dv = grads
    assert dq.shape == (b, h, sq, d) and (dq == 0).all()
    assert dk.shape == dv.shape == (b, hkv, skv, d)
    assert (dk == 0).all() and (dv == 0).all()


@pytest.mark.parametrize("sq,skv", [(0, 48), (32, 0)])
def test_empty_lengths(sq, skv):
    q, k, v, g, _ = _case(3, 2, 4, 2, sq, skv)
    tq, tk, tv, tg = (torch.tensor(x) for x in (q, k, v, g))
    out, lse = fa.flash_attention_fwd(tq, tk, tv, causal=True, kv_offset=5)
    grads = fa.flash_attention_bwd(tq, tk, tv, out, lse, tg, causal=True,
                                   kv_offset=5)
    _check_empty_lengths(out, lse, grads, 2, 4, 2, sq, skv, 16)


@pytest.mark.parametrize("shape,groups", [
    ((1, 1, 8, 12), 1), ((2, 1, 8, 12), 2), ((2, 3, 8, 12), 6),
    ((8, 12), 1), ((1, 8, 12), 1), ((1, 3, 8, 12), 6)])
def test_norm_mask_groups(shape, groups):
    mask = torch.from_numpy(np.random.default_rng(0).random(shape) > 0.5)
    g = fa.norm_mask(mask, 2, 3, 8, 12)
    assert g.dtype == torch.int8 and tuple(g.shape) == (groups, 8, 12)
    full = mask.broadcast_to(2, 3, 8, 12).reshape(6, 8, 12)
    idx = fa._group_index(groups, 2, 3)
    assert torch.equal(g[idx].bool(), full)
    with pytest.raises(ValueError, match="ambiguous"):
        fa.norm_mask(torch.ones(2, 8, 12, dtype=torch.bool), 2, 3, 8, 12)


@pytest.mark.parametrize("kwargs,match", [
    (dict(d=32), "head_dim"), (dict(dtype=torch.float16), "bf16 or f32"),
    (dict(contiguous=False), "contiguous"), (dict(offset=1), "16-byte")])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(kwargs, match):
    d = kwargs.get("d", 64)
    dtype = kwargs.get("dtype", torch.bfloat16)
    q = torch.empty(1, 2, 8, d, dtype=dtype, device="meta")
    k = torch.empty(1, 2, 8, d, dtype=dtype, device="meta")
    if not kwargs.get("contiguous", True):
        k = torch.empty(1, 8, 2, d, dtype=dtype, device="meta").transpose(1, 2)
    if kwargs.get("offset"):       # contiguous, but not on a 16-byte boundary
        flat = torch.empty(kwargs["offset"] + q.numel(), dtype=dtype,
                           device="meta")
        q = flat[kwargs["offset"]:].view(q.shape)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_fwd(q, k, k)


@pytest.mark.parametrize("causal,masked,offset", [
    (True, False, None), (False, True, None), (True, True, 5),
    (True, False, "ragged")])
def test_local_attention_matches_jax_and_is_differentiable(causal, masked,
                                                           offset):
    q, k, v, g, _ = _case(11, 2, 4, 2, 8, 16)
    mask = np.random.default_rng(1).random((2, 1, 8, 16)) > 0.4 \
        if masked else None
    if masked:
        mask[1, 0, 2] = False
    off = np.array([3, 8], np.int32) if offset == "ragged" else offset
    ref = local_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal,
                              mask=None if mask is None else jnp.asarray(mask),
                              kv_offset=None if off is None
                              else jnp.asarray(off))
    tq = torch.tensor(q, requires_grad=True)
    out = local_attention(tq, torch.tensor(k), torch.tensor(v), causal=causal,
                          mask=None if mask is None else torch.tensor(mask),
                          kv_offset=None if off is None
                          else torch.as_tensor(off))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=FP32_ATOL, rtol=0)
    out.sum().backward()
    assert torch.isfinite(tq.grad).all() and tq.grad.abs().sum() > 0


def test_sdpa_backends():
    q, k, v, _, _ = _case(5, 2, 2, 2, 8, 8, d=16)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    xla = sdpa(tq, tk, tv, causal=True, backend="xla")
    pallas = sdpa(tq, tk, tv, causal=True, backend="pallas")
    torch.testing.assert_close(pallas, xla, atol=FP32_ATOL, rtol=0)
    # a per-row kv_offset takes the plain path, as in the JAX package
    before = fa.flash_attention_fwd.launches
    ragged = sdpa(tq, tk, tv, causal=True, backend="pallas",
                  kv_offset=torch.tensor([0, 0]))
    torch.testing.assert_close(ragged, xla, atol=FP32_ATOL, rtol=0)
    assert fa.flash_attention_fwd.launches == before
    with pytest.raises(RuntimeError, match="ring"):
        sdpa(tq, tk, tv, backend="ring")
    with pytest.raises(ValueError, match="backend"):
        sdpa(tq, tk, tv, backend="cudnn")


# (name, B, H, H_kv, Sq, Skv, D, causal, kv_offset, mask groups): the shapes
# where the kernels' tiles break first (bf16: 128 q rows and 128 keys in
# the forward, 64 q rows and 2 x 64 keys in the backward; f32: 64 and 64):
# a single row, lengths one short of and one past a tile, a ragged 1000, q
# shorter than the keys at an offset, head dim 128, GQA 12/4 and 12/1, and
# every mask grouping with a fully masked row (``_case`` row 3)
CARD_CASES = [
    ("mask_gB_offset30_gqa4_2", 2, 4, 2, 100, 130, 64, True, 30, "B"),
    ("mask_gB_offset30_d128", 2, 2, 2, 100, 130, 128, True, 30, "B"),
    ("s1", 2, 2, 2, 1, 1, 64, True, 0, None),
    ("s127", 2, 2, 2, 127, 127, 64, True, 0, None),
    ("s129", 2, 2, 2, 129, 129, 64, True, 0, None),
    ("s1000", 1, 2, 2, 1000, 1000, 64, True, 0, None),
    ("sq64_skv1000_offset936", 1, 2, 2, 64, 1000, 64, True, 936, None),
    ("sq1_skv700_offset699", 2, 2, 2, 1, 700, 64, True, 699, None),
    ("sq100_skv300_offset150", 1, 2, 2, 100, 300, 64, True, 150, None),
    ("d128_s300", 1, 2, 2, 300, 300, 128, True, 0, None),
    ("d128_noncausal_s200", 1, 2, 2, 200, 200, 128, False, 0, None),
    ("gqa12_4", 1, 12, 4, 256, 256, 64, True, 0, None),
    ("gqa12_1", 1, 12, 1, 256, 256, 64, True, 0, None),
    ("mask_g1", 2, 2, 2, 200, 200, 64, False, 0, "1"),
    ("mask_gB", 2, 2, 2, 200, 200, 64, True, 0, "B"),
    ("mask_gBH", 2, 2, 2, 200, 200, 64, True, 0, "BH"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_kernel_matches_plain_on_card(dtype, case):
    """K4 and K7 against their plain versions, bf16 through the tensor-core
    bodies and f32 through the SIMT ones, under the limits
    ``chip_smoke.flash_check`` states (O, dQ, dK and dV element by element,
    the logsumexp, dead rows exactly 0 with lse +inf) and a bound on each
    output's largest error; then K7 once more, whose dQ may differ from the
    first only by the order of the adds into dq_acc."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    import chip_smoke

    name, b, h, hkv, sq, skv, d, causal, off, groups = case
    dt = getattr(torch, dtype)
    q, k, v, g, mask = _case(3, b, h, hkv, sq, skv, d=d, groups=groups)
    q, k, v, g = (torch.tensor(x, device="cuda").to(dt) for x in (q, k, v, g))
    tm = None if mask is None else fa.norm_mask(
        torch.tensor(mask, device="cuda"), b, h, sq, skv)
    chip_smoke.flash_check(name, dict(q=q, k=k, v=v, do=g, mask=tm,
                                      causal=causal, kv_offset=off))
    kw = dict(causal=causal, mask=tm, kv_offset=off)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    refs = fa.flash_attention_backward_reference(q, k, v, out, lse, g, **kw)
    # beside flash_check's limits, the bound this test held before: the
    # largest error against the largest reference element; f32 differs in
    # summation order, bf16 rounds p (and ds) and the outputs
    rel = 1e-5 if dtype == "float32" else 2 ** -6
    assert ((out.float() - ref.float()).abs().max()
            <= 1e-5 + rel * ref.float().abs().max())
    assert torch.equal(torch.isinf(lse), torch.isinf(ref_lse))
    for a, r in zip(grads, refs):
        assert (a.float() - r.float()).abs().max() \
            <= 1e-5 + rel * r.float().abs().max()
    dq1 = grads[0].float()
    dq2 = fa.flash_attention_bwd(q, k, v, out, lse, g, **kw)[0].float()
    # the f32 sums in dq_acc differ in their last bits, which the cast to
    # bf16 may round one unit (2^-7 relative) apart; f32 keeps them
    rel = 1e-5 if dtype == "float32" else 2 ** -7
    assert ((dq1 - dq2).abs() <= 1e-5 + rel * dq1.abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv", [(0, 130), (100, 0)])
def test_empty_lengths_on_card(dtype, d, sq, skv):
    """Sq = 0 or Skv = 0 through both bodies: the kernels return what the
    plain versions do (``test_empty_lengths``)."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    q, k, v, g, _ = _case(3, 2, 4, 2, sq, skv, d=d)
    q, k, v, g = (torch.tensor(x, device="cuda").to(getattr(torch, dtype))
                  for x in (q, k, v, g))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, kv_offset=30)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True,
                                   kv_offset=30)
    torch.cuda.synchronize()
    _check_empty_lengths(out, lse, grads, 2, 4, 2, sq, skv, d)


if __name__ == "__main__":
    # the bf16 readings the module docstring quotes
    for c in CASES:
        l2, mx, f32 = _bf16_readings(c)
        print(f"{c[0]:15s} port rel L2 (O dQ dK dV) "
              + " ".join(f"{x:.2e}" for x in l2) + "  max "
              + " ".join(f"{x:.2e}" for x in mx) + "  JAX FP32 rel L2 "
              + " ".join(f"{x:.2e}" for x in f32))
