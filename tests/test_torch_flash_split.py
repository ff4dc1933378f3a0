"""Port parity: the split flash backward (K5 dQ, K6 dK/dV) and the rule
that picks it over the fused backward (K7).

The rule: the port's ``_fused_bwd_applicable`` and ``use_fused_bwd``
against the JAX package's ``_fused_bwd_applicable`` over a grid of
lengths, head dims and itemsizes, including the edges where bf16 at D=64
leaves the fused path (29,184 / 29,696) and f32 does (19,968 / 20,480),
with ``TNN_FLASH_FUSED_BWD`` at 0 and 1.

The backward: ``flash_attention`` on CPU tensors, its backward forced onto
the split path, against the JAX package's Pallas ``flash_attention`` run in
interpret mode with the same switch (``tests/test_attention.py`` forces it
the same way), on the same numpy-seeded inputs: causal, a padding mask,
``kv_offset``, the causal short query (Sq < Skv, no offset) and GQA.
FP32: both sides compute in float32 and differ in summation order only:
1e-5 absolute on gradients of magnitude below 10. bf16: both sides run on
the same bf16 inputs, the JAX kernels with one 64-wide kv block; each
gradient must lie within 2**-12 of the reference in relative L2 norm and
2**-7 of its largest element, the bounds of the fused backward's test
(``tests/test_torch_flash_attention.py``), and the JAX kernels run in FP32
on the same values must fall outside. ``python -m
tests.test_torch_flash_split`` (with ``XLA_FLAGS=
--xla_backend_optimization_level=0``, the suite's flag) prints the
readings: over the cases dK and dV are bit for bit equal and dQ reads at
most 6.7e-8 relative L2 and 1.9e-7 of the largest element (f32 sums in
another order); the JAX FP32 kernels read at least 2.11e-3.

A spy on the three wrappers shows which backward ran. The wrappers
return zeros at Sq = 0 or Skv = 0 and refuse bf16 tensors whose bases the
tensor-core bodies' TMA maps cannot take. The CUDA kernels run only on
the card: the ``cuda`` tests skip here; there they hold K5 and K6 (bf16
on the tensor cores, f32 on the SIMT bodies) to
``chip_smoke.split_check``'s limits at the shapes where their tiles break
first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu.ops.pallas import flash_attention as jfa
from tnn_tpu_torch.ops import flash_attention as fa

FP32_ATOL = 1e-5
BF16_REL_L2, BF16_REL_MAX = 2 ** -12, 2 ** -7

# (name, B, H, H_kv, Sq, Skv, causal, kv_offset, mask groups)
CASES = [
    ("causal", 2, 2, 2, 64, 64, True, None, None),
    ("mask_gB", 2, 2, 2, 32, 48, True, None, "B"),
    ("offset", 2, 4, 2, 16, 64, True, 40, None),
    ("short_query", 1, 2, 2, 20, 64, True, None, None),
    ("gqa", 2, 4, 1, 40, 40, True, None, None),
    ("mask_gBH_noncausal", 1, 2, 2, 24, 40, False, None, "BH"),
]


def _case(seed, b, h, hkv, sq, skv, groups=None, d=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    g = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    mask = None
    if groups is not None:
        shape = {"B": (b, 1, sq, skv), "BH": (b, h, sq, skv)}[groups]
        mask = rng.random(shape) > 0.3
        mask[0, 0, 3, :] = False                 # a fully masked row
    return q, k, v, g, mask


def _jax_grads(q, k, v, g, mask, causal, off, dtype=jnp.float32,
               block_k=32):
    def f(q, k, v):
        return jfa.flash_attention(
            q, k, v, causal, None, 32, block_k, 32, block_k,
            mask=None if mask is None else jnp.asarray(mask), kv_offset=off)

    q, k, v, g = (jnp.asarray(x, dtype) for x in (q, k, v, g))
    _, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(x.astype(jnp.float32)) for x in vjp(g)]


def _port_grads(q, k, v, g, mask, causal, off, dtype=torch.float32):
    tq, tk, tv = (torch.tensor(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal,
                             mask=None if mask is None
                             else torch.tensor(mask), kv_offset=off)
    (out.float() * torch.tensor(g)).sum().backward()
    return [x.grad.float().numpy() for x in (tq, tk, tv)]


class _Spy:
    """Counts the calls of the three backward wrappers."""

    def __init__(self, monkeypatch):
        self.calls = {}
        for name in ("flash_attention_bwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            real = getattr(fa, name)

            def spy(*a, _real=real, _name=name, **kw):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _real(*a, **kw)

            monkeypatch.setattr(fa, name, spy)


SEQS = [1, 8, 100, 512, 513, 4096, 16384, 19968, 20480, 29184, 29696,
        32768]


@pytest.mark.parametrize("switch", ["0", "1"])
def test_selection_rule_matches_jax(monkeypatch, switch):
    monkeypatch.setenv("TNN_FLASH_FUSED_BWD", switch)
    for s in SEQS:
        for d in (64, 128):
            for itemsize, dtype in ((2, torch.bfloat16), (4, torch.float32)):
                jbq, jbk, jsq_p, _ = jfa._block_geometry(s, s, 512, 512)
                want = jfa._fused_bwd_applicable(jsq_p, d, jbq, jbk, itemsize)
                assert fa._block_geometry(s, s, 512, 512) == \
                    jfa._block_geometry(s, s, 512, 512)
                assert fa._fused_bwd_applicable(
                    jsq_p, d, jbq, jbk, itemsize) == want, (s, d, itemsize)
                q = torch.empty(1, 1, s, d, dtype=dtype, device="meta")
                assert fa.use_fused_bwd(q, q) == want, (s, d, itemsize)
    assert fa._FUSED_BWD_MAX_BYTES == jfa._FUSED_BWD_MAX_BYTES == 12 * 2**20


_BUDGET_PROBE = """
import torch
from tnn_tpu.ops.pallas import flash_attention as jfa
from tnn_tpu_torch.ops import flash_attention as fa
assert fa._FUSED_BWD_MAX_BYTES == jfa._FUSED_BWD_MAX_BYTES == 4 * 2**20
picks = []
for s in %r:
    jbq, jbk, jsq_p, _ = jfa._block_geometry(s, s, 512, 512)
    want = jfa._fused_bwd_applicable(jsq_p, 64, jbq, jbk, 2)
    q = torch.empty(1, 1, s, 64, dtype=torch.bfloat16, device="meta")
    assert fa.use_fused_bwd(q, q) == want, s
    picks.append(want)
print(picks)
""" % (SEQS,)


def test_budget_variable_moves_both_rules():
    """``TNN_FLASH_FUSED_BWD_MAX_BYTES``, read at import by both packages,
    moves both rules alike: at 4 MiB bf16 at D=64 leaves the fused path
    from S = 8,192 on (12 MiB: from 29,696)."""
    import ast
    import os
    import subprocess
    import sys

    env = dict(os.environ, TNN_FLASH_FUSED_BWD_MAX_BYTES=str(4 * 2**20),
               TNN_FLASH_FUSED_BWD="1", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _BUDGET_PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr[-2000:]
    picks = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert picks == [s < 8192 for s in SEQS]


@pytest.mark.parametrize("dtype,fused,split", [
    (torch.bfloat16, 29184, 29696), (torch.float32, 19968, 20480)])
def test_selection_rule_edges(dtype, fused, split):
    for s, want in ((fused, True), (split, False), (32768, False)):
        q = torch.empty(1, 12, s, 64, dtype=dtype, device="meta")
        k = torch.empty(1, 4, s, 64, dtype=dtype, device="meta")
        assert fa.use_fused_bwd(q, k) is want, s


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_backward_matches_jax_fp32(monkeypatch, case):
    _, b, h, hkv, sq, skv, causal, off, groups = case
    q, k, v, g, mask = _case(len(case[0]), b, h, hkv, sq, skv, groups)
    monkeypatch.setenv("TNN_FLASH_FUSED_BWD", "0")
    wrappers = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [w.launches for w in wrappers]
    spy = _Spy(monkeypatch)
    ref = _jax_grads(q, k, v, g, mask, causal, off)
    got = _port_grads(q, k, v, g, mask, causal, off)
    assert spy.calls == {"flash_attention_bwd_dq": 1,
                         "flash_attention_bwd_dkv": 1}
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a, r, atol=FP32_ATOL, rtol=0,
                                   err_msg=name)
    # on CPU tensors the wrappers take the plain versions: no launches
    assert [w.launches for w in wrappers] == before


def test_rule_picks_split_by_size_and_fused_below(monkeypatch):
    """With the budget shrunk so that 64 rows overflow it, the backward
    takes K5 + K6 at Sq = 64 and K7 at Sq = 8 (the switch left on)."""
    q, k, v, g, _ = _case(3, 1, 2, 1, 64, 64)
    budget = 40 * 1024
    for mod in (fa, jfa):
        monkeypatch.setattr(mod, "_FUSED_BWD_MAX_BYTES", budget)
    monkeypatch.setenv("TNN_FLASH_FUSED_BWD", "1")
    _, bq, sq_p, _ = fa._block_geometry(64, 64, 512, 512)
    assert not jfa._fused_bwd_applicable(sq_p, 16, bq, bq, 4)
    spy = _Spy(monkeypatch)
    got = _port_grads(q, k, v, g, None, True, None)
    assert spy.calls == {"flash_attention_bwd_dq": 1,
                         "flash_attention_bwd_dkv": 1}
    for a, r in zip(got, _jax_grads(q, k, v, g, None, True, None)):
        np.testing.assert_allclose(a, r, atol=FP32_ATOL, rtol=0)
    spy.calls.clear()
    _port_grads(q[:, :, :8], k[:, :, :8], v[:, :, :8], g[:, :, :8], None,
                True, None)
    assert spy.calls == {"flash_attention_bwd": 1}


def _bf16_readings(case):
    """(dQ, dK, dV) relative L2 and max-element errors of the port's bf16
    split backward against the JAX split kernels in bf16, and the relative
    L2 errors of the JAX split kernels in FP32 on the same bf16 values."""
    _, b, h, hkv, sq, skv, causal, off, groups = case
    q, k, v, g, mask = _case(7, b, h, hkv, sq, skv, groups)
    q, k, v, g = (torch.tensor(x).bfloat16().float().numpy()
                  for x in (q, k, v, g))
    assert skv <= 64        # one kv block on the JAX side
    ref = _jax_grads(q, k, v, g, mask, causal, off, jnp.bfloat16, 64)
    got = _port_grads(q, k, v, g, mask, causal, off, torch.bfloat16)
    f32 = _jax_grads(q, k, v, g, mask, causal, off, jnp.float32, 64)

    def rel_l2(a, r):
        return np.linalg.norm(a - r) / np.linalg.norm(r)

    return ([rel_l2(a, r) for a, r in zip(got, ref)],
            [np.abs(a - r).max() / np.abs(r).max() for a, r in zip(got, ref)],
            [rel_l2(a, r) for a, r in zip(f32, ref)])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_backward_matches_jax_bf16(monkeypatch, case):
    monkeypatch.setenv("TNN_FLASH_FUSED_BWD", "0")
    l2, mx, f32 = _bf16_readings(case)
    for name, a, m, f in zip(("dq", "dk", "dv"), l2, mx, f32):
        assert a <= BF16_REL_L2 and m <= BF16_REL_MAX, (name, a, m)
        assert f > BF16_REL_L2, (name, f)   # the bound rejects FP32 math


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv", [(0, 48), (32, 0)])
def test_split_wrappers_take_empty_lengths(dtype, sq, skv):
    """Sq = 0 or Skv = 0: K5's and K6's wrappers return zeros of the
    gradients' shapes and dtypes (no key: every row is dead, dQ = 0; no q
    row: dK = dV = 0)."""
    q, k, v, g, _ = _case(3, 2, 4, 2, sq, skv)
    tq, tk, tv, tg = (torch.tensor(x).to(dtype) for x in (q, k, v, g))
    _check_split_empty(tq, tk, tv, tg)


@pytest.mark.parametrize("wrapper", ["flash_attention_bwd_dq",
                                     "flash_attention_bwd_dkv"])
@pytest.mark.parametrize("tensor", ["q", "do"])
def test_split_wrappers_refuse_unaligned_tma_bases(wrapper, tensor):
    """The bf16 K5 and K6 read q, k, v and dO through TMA, whose maps need
    16-byte-aligned bases: a tensor one element off is refused with a
    ``ValueError`` before any launch."""
    shape = (1, 2, 8, 64)
    x = {n: torch.empty(shape, dtype=torch.bfloat16, device="meta")
         for n in ("q", "k", "o", "do")}
    flat = torch.empty(1 + x[tensor].numel(), dtype=torch.bfloat16,
                       device="meta")
    x[tensor] = flat[1:].view(shape)
    lse = torch.empty(shape[:3], dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="16-byte"):
        getattr(fa, wrapper)(x["q"], x["k"], x["k"], x["o"], lse, x["do"],
                             causal=True)


def _check_split_empty(q, k, v, g):
    kw = dict(causal=True, kv_offset=5)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, g, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, g, **kw)
    if q.is_cuda:
        torch.cuda.synchronize()
    assert dq.shape == q.shape and dq.dtype == q.dtype
    assert dk.shape == dv.shape == k.shape
    assert dk.dtype == dv.dtype == k.dtype
    assert (dq == 0).all() and (dk == 0).all() and (dv == 0).all()


# (name, B, H, H_kv, Sq, Skv, D, causal, kv_offset, mask groups): where the
# tensor-core tiles (K5: 128 q rows x 128 keys at D = 64, 64 keys at D =
# 128; K6: 128 keys x 64-row q tiles) break first. Every masked case holds
# a fully masked row.
CARD_CASES = [
    ("mask_gB_offset30_gqa4_2", 2, 4, 2, 100, 130, 64, True, 30, "B"),
    ("mask_gB_offset30_d128", 2, 2, 2, 100, 130, 128, True, 30, "B"),
    ("s1", 2, 2, 2, 1, 1, 64, True, 0, None),
    ("s127", 2, 2, 2, 127, 127, 64, True, 0, None),
    ("s129", 2, 2, 2, 129, 129, 64, True, 0, None),
    ("s1000", 1, 2, 2, 1000, 1000, 64, True, 0, None),
    ("s1000_d128", 1, 2, 2, 1000, 1000, 128, True, 0, None),
    ("sq64_skv1000_offset936", 1, 2, 2, 64, 1000, 64, True, 936, None),
    ("sq1_skv700_offset699", 2, 2, 2, 1, 700, 64, True, 699, None),
    ("sq100_skv300_offset150", 1, 2, 2, 100, 300, 64, True, 150, None),
    ("sq100_skv300_offset150_d128", 1, 2, 2, 100, 300, 128, True, 150,
     None),
    ("d128_s300", 1, 2, 2, 300, 300, 128, True, 0, None),
    ("d128_noncausal_s200", 1, 2, 2, 200, 200, 128, False, 0, None),
    ("noncausal_sq130_skv333", 1, 2, 2, 130, 333, 64, False, 0, None),
    ("gqa12_4", 1, 12, 4, 256, 256, 64, True, 0, None),
    ("gqa12_4_d128", 1, 12, 4, 256, 256, 128, True, 0, None),
    ("mask_g1", 2, 2, 2, 200, 200, 64, False, 0, "1"),
    ("mask_gB", 2, 2, 2, 200, 200, 64, True, 0, "B"),
    ("mask_gBH", 2, 2, 2, 200, 200, 64, True, 0, "BH"),
    ("mask_gBH_d128", 2, 2, 2, 200, 200, 128, True, 0, "BH"),
]


def _card_case(b, h, hkv, sq, skv, d, groups):
    """``_case`` with the "1" grouping too (one fully masked row)."""
    q, k, v, g, mask = _case(2, b, h, hkv, sq, skv,
                             None if groups is None else "B", d=d)
    if groups == "1":
        mask = mask[:1]
    elif groups == "BH":
        mask = np.broadcast_to(mask, (b, h, sq, skv)).copy()
        mask[b - 1, h - 1, sq // 2, :] = False
    return q, k, v, g, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_split_kernels_match_plain_on_card(dtype, case):
    """K5 and K6 against the plain backward, bf16 through the tensor-core
    bodies and f32 through the SIMT ones, under the limits
    ``chip_smoke.split_check`` states (dQ, dK and dV element by element,
    dead rows' dQ exactly 0) and the bound this test held before on each
    gradient's largest error; K5 twice gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    import chip_smoke

    name, b, h, hkv, sq, skv, d, causal, off, groups = case
    dt = getattr(torch, dtype)
    q, k, v, g, mask = _card_case(b, h, hkv, sq, skv, d, groups)
    q, k, v, g = (torch.tensor(x, device="cuda").to(dt) for x in (q, k, v, g))
    tm = None if mask is None else fa.norm_mask(
        torch.tensor(mask, device="cuda"), b, h, sq, skv)
    chip_smoke.split_check(name, dict(q=q, k=k, v=v, do=g, mask=tm,
                                      causal=causal, kv_offset=off))
    kw = dict(causal=causal, mask=tm, kv_offset=off)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, g, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, g, **kw)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (before[0] + 2,
                                                     before[1] + 1)
    assert torch.equal(dq, dq2)
    refs = fa.flash_attention_backward_reference(q, k, v, out, lse, g, **kw)
    # beside split_check's limits, the bound this test held before: f32
    # differs in summation order; bf16 rounds p (and ds) and the outputs
    rel = 1e-5 if dtype == "float32" else 2 ** -6
    for a, r in zip((dq, dk, dv), refs):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert (a.float() - r.float()).abs().max() \
            <= 1e-5 + rel * r.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv", [(0, 130), (100, 0)])
def test_split_empty_lengths_on_card(dtype, d, sq, skv):
    """Sq = 0 or Skv = 0 through K5's and K6's bodies, whose tensor maps
    cannot have 0 rows: the kernels return what the plain versions do
    (``test_split_wrappers_take_empty_lengths``)."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    q, k, v, g, _ = _case(3, 2, 4, 2, sq, skv, d=d)
    _check_split_empty(*(torch.tensor(x, device="cuda").to(
        getattr(torch, dtype)) for x in (q, k, v, g)))


if __name__ == "__main__":
    # the bf16 readings the module docstring quotes
    import os

    os.environ["TNN_FLASH_FUSED_BWD"] = "0"
    for c in CASES:
        l2, mx, f32 = _bf16_readings(c)
        print(f"{c[0]:19s} port rel L2 (dQ dK dV) "
              + " ".join(f"{x:.2e}" for x in l2) + "  max "
              + " ".join(f"{x:.2e}" for x in mx) + "  JAX FP32 rel L2 "
              + " ".join(f"{x:.2e}" for x in f32))
