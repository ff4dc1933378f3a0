"""The card's bf16 limit admits the reference's own rounding at the tile
widths of the tensor-core flash kernels.

The bf16 forward (K4) rounds p to bf16 at the running maximum of each
128-key tile; the fused backward (K7) walks 64-row q tiles against 128-key
tiles. The plain versions round p at the row's final maximum. JAX's Pallas
``flash_attention``, run in interpret mode as the other port tests run it,
with ``block_q = block_k = 128``, ``block_q_bwd = 64`` and ``block_k_bwd =
128``, rounds at those same points. Its O, dQ, dK and dV on bf16 inputs must
lie within the limit ``chip_smoke.flash_check`` holds the kernels to
(``chip_smoke.TOLERANCE["bfloat16"]`` with the magnitudes of
``chip_smoke.backward_magnitudes``) of the port's plain versions: the
limit, unchanged, covers rounding at the new tile widths. Readings (share
of the limit, O dQ dK dV; with the suite's XLA flag): causal 0.26 0.24
0.34 0.14, GQA 0.24 0.21 0.31 0.00; at 32-wide blocks 0.33 0.33 0.41
0.14 and 0.29 0.36 0.32 0.00.

The split backward takes the tiles of its tensor-core bodies: K5 walks
128-row q tiles against 128-key tiles (D = 64), K6 128-key blocks against
64-row q tiles. JAX's split path (``TNN_FLASH_FUSED_BWD=0``) with
``block_q_bwd``/``block_k_bwd`` at those tiles must lie within the same
limit of the plain backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tnn_tpu.ops.pallas import flash_attention as jfa
from tnn_tpu.ops.pallas.flash_attention import flash_attention as jflash
from tnn_tpu_torch.ops import flash_attention as fa

FWD_Q, FWD_K = 128, 128     # K4: q rows of a block, keys of a tile
BWD_Q, BWD_K = 64, 128      # K7: q rows of a streamed tile, keys of a block
# the split backward: (q rows, keys) of K5's tiles and of K6's
SPLIT_TILES = [("k5", 128, 128), ("k6", 64, 128)]

# (name, H, H_kv); B=1, S=256, D=64, causal
CASES = [("causal", 2, 2), ("gqa", 2, 1)]


def _inputs(h, hkv, b=1, s=256, d=64):
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=sh).astype(np.float32) for sh in
               ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    g = rng.normal(size=(b, h, s, d)).astype(np.float32)
    return tuple(torch.tensor(x).bfloat16() for x in (q, k, v, g))


def _jax_out_and_grads(tq, tk, tv, tg, bwd_q, bwd_k):
    def f(q, k, v):
        return jflash(q, k, v, True, None, FWD_Q, FWD_K, bwd_q, bwd_k)

    jq, jk, jv, jg = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                      for x in (tq, tk, tv, tg))
    out, vjp = jax.vjp(f, jq, jk, jv)
    return [torch.tensor(np.asarray(x.astype(jnp.float32)))
            for x in (out, *vjp(jg))]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_rounding_at_kernel_tiles_within_card_limit(case):
    name, h, hkv = case
    tq, tk, tv, tg = _inputs(h, hkv)
    got = _jax_out_and_grads(tq, tk, tv, tg, BWD_Q, BWD_K)

    o, lse = fa.flash_attention_reference(tq, tk, tv, causal=True)
    refs = fa.flash_attention_backward_reference(tq, tk, tv, o, lse, tg,
                                                 causal=True)
    mag_o = fa.flash_attention_reference(tq, tk, tv.abs(),
                                         causal=True)[0].float()
    mags = chip_smoke.backward_magnitudes(tq, tk, tv, o, lse, tg,
                                          causal=True, mask=None,
                                          kv_offset=0)
    for gname, a, r, mag in zip(("o", "dq", "dk", "dv"), got, (o, *refs),
                                (mag_o, *mags)):
        assert a.shape == r.shape, gname
        err, used = chip_smoke._limit_used(a, r, mag, "bfloat16")
        assert used <= 1.0, (name, gname, err, used)


@pytest.mark.parametrize("tiles", SPLIT_TILES, ids=[t[0] for t in SPLIT_TILES])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_rounding_at_kernel_tiles_within_card_limit(monkeypatch, case,
                                                          tiles):
    """JAX's split backward (its fused kernel refused) at K5's or K6's
    tiles, against the port's plain backward, within the card's limit."""
    name, h, hkv = case
    tname, bwd_q, bwd_k = tiles
    monkeypatch.setenv("TNN_FLASH_FUSED_BWD", "0")

    def fused(*a, **kw):
        raise AssertionError("the split path must run")

    monkeypatch.setattr(jfa, "_flash_bwd_fused", fused)
    tq, tk, tv, tg = _inputs(h, hkv)
    got = _jax_out_and_grads(tq, tk, tv, tg, bwd_q, bwd_k)[1:]
    o, lse = fa.flash_attention_reference(tq, tk, tv, causal=True)
    refs = fa.flash_attention_backward_reference(tq, tk, tv, o, lse, tg,
                                                 causal=True)
    mags = chip_smoke.backward_magnitudes(tq, tk, tv, o, lse, tg,
                                          causal=True, mask=None,
                                          kv_offset=0)
    for gname, a, r, mag in zip(("dq", "dk", "dv"), got, refs, mags):
        assert a.shape == r.shape, gname
        err, used = chip_smoke._limit_used(a, r, mag, "bfloat16")
        assert used <= 1.0, (name, tname, gname, err, used)
