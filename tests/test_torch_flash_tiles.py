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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tnn_tpu.ops.pallas.flash_attention import flash_attention as jflash
from tnn_tpu_torch.ops import flash_attention as fa

FWD_Q, FWD_K = 128, 128     # K4: q rows of a block, keys of a tile
BWD_Q, BWD_K = 64, 128      # K7: q rows of a streamed tile, keys of a block

# (name, H, H_kv); B=1, S=256, D=64, causal
CASES = [("causal", 2, 2), ("gqa", 2, 1)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_rounding_at_kernel_tiles_within_card_limit(case):
    name, h, hkv = case
    b, s, d = 1, 256, 64
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=sh).astype(np.float32) for sh in
               ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    g = rng.normal(size=(b, h, s, d)).astype(np.float32)
    tq, tk, tv, tg = (torch.tensor(x).bfloat16() for x in (q, k, v, g))

    def f(q, k, v):
        return jflash(q, k, v, True, None, FWD_Q, FWD_K, BWD_Q, BWD_K)

    jq, jk, jv, jg = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                      for x in (tq, tk, tv, tg))
    out, vjp = jax.vjp(f, jq, jk, jv)
    got = [torch.tensor(np.asarray(x.astype(jnp.float32)))
           for x in (out, *vjp(jg))]

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
