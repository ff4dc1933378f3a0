"""Port parity: int8 weights (quantizers, w8a8, the int8 matmul, qmatmul,
the quantized GPT-2).

The same numpy-seeded inputs go through the JAX package and the port.

- The quantizers and ``quantize_for_decode`` are bit for bit equal: the
  same IEEE division and round-half-even on both sides.
- ``w8a8_matmul`` is an exact int32 product rescaled by the same f32
  multiplies: bit for bit on f32 input, and within one bf16 ulp when the
  result is rounded to bf16.
- ``int8_matmul``'s plain version is held against JAX's Pallas kernel in
  interpret mode: the same f32 sums in another order, so 1e-6 of the
  largest output for f32 x; for a bf16 result one bf16 ulp of the element
  on top of that (an element that cancels to near 0 keeps the f32 order
  error, which can exceed its own ulp: 3.98e-5 against 3.81e-5 seen).
- The quantized tiny GPT-2 (2L/256d/4h, vocab 512: every matmul has both
  dims >= 128, so 9 weights quantize) against the JAX model on the same
  ``Int8Weight`` bytes: 1e-5 of the largest logit under FP32; under
  MIXED_BF16 against the JAX model under MIXED_BF16, at a bound set
  between two readings (``test_quantized_gpt2_bf16_within_bound``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.nn import quant as jquant
from tnn_tpu.ops.pallas import paged_attention as jpa
from tnn_tpu.ops.pallas import quant_matmul as jqm
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.nn import quant as tquant
from tnn_tpu_torch.ops import paged_attention as tpa
from tnn_tpu_torch.ops import quant_matmul as tqm

QMODEL = dict(vocab_size=512, max_len=160, num_layers=2, d_model=256,
              num_heads=4)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x|: 2^(exponent - 7)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _to_torch_iw(jw):
    return tqm.Int8Weight(torch.tensor(np.asarray(jw.q)),
                          torch.tensor(np.asarray(jw.scale)),
                          n=jw.n, k=jw.k)


# -- quantizers ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_bit_exact(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7, 3, 64)).astype(np.float32) * 3
    x[1, 2, 0] = 0.0                   # the 1e-8 clamp: all-zero row
    x[2, 0, 1, :5] = [0.5, -0.5, 1.5, 2.5, -127.0]   # ties round to even
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy()).astype(dtype)
    jq, js = jpa.quantize_kv_rows(jx)
    q, s = tpa.quantize_kv_rows(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[1, 2, 0, 0]) == np.float32(1e-8) / np.float32(127.0)


@pytest.mark.parametrize("k,n", [(300, 130), (768, 256), (128, 512)])
def test_quantize_int8_bit_exact_with_padding(k, n):
    rng = np.random.default_rng(k + n)
    w = rng.normal(size=(k, n)).astype(np.float32)
    w[:, 3] = 0.0                      # scale 1.0 where a column is zero
    jw = jqm.quantize_int8(w)
    tw = tqm.quantize_int8(torch.from_numpy(w))
    assert (tw.n, tw.k, tw.shape) == (jw.n, jw.k, jw.shape) == (n, k, (k, n))
    assert tuple(tw.q.shape) == jw.q.shape and tw.q.shape[0] % 128 == 0 \
        and tw.q.shape[1] % 128 == 0
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    assert float(tw.scale[3]) == 1.0
    if n % 128:                        # padded channels: scale 1.0, q 0
        assert float(tw.scale[-1]) == 1.0 and not tw.q[n:].any()
    np.testing.assert_array_equal(tw.dequant().numpy(),
                                  np.asarray(jw.dequant()))


@pytest.fixture(scope="module")
def qpair():
    """The 2L/256d JAX model, its params and their ``quantize_for_decode``
    tree, and the port model with the same float weights."""
    jm = JGPT2(**QMODEL, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (2, 16))["params"]
    tm = GPT2(**QMODEL, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, jquant.quantize_for_decode(params), tm


def _jax_int8_leaves(tree, path=()):
    if isinstance(tree, jqm.Int8Weight):
        return {path: tree}
    out = {}
    if isinstance(tree, dict):
        for key, value in tree.items():
            out.update(_jax_int8_leaves(value, path + (key,)))
    return out


def test_quantize_for_decode_bit_exact_and_copy(qpair):
    jm, params, jq, tm = qpair
    qm = tquant.quantize_for_decode(tm)
    mine = {path: w for path, w in qm.jax_param_paths()
            if isinstance(w, tqm.Int8Weight)}
    theirs = _jax_int8_leaves(jq)
    assert sorted(mine) == sorted(theirs) and len(mine) == 9
    for path, jw in theirs.items():
        tw = mine[path]
        assert (tw.n, tw.k) == (jw.n, jw.k), path
        np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
        np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    # the caller's model keeps its float parameters; the copy shares the
    # float weights it left alone and keeps no master of the int8 ones
    assert all(isinstance(w, torch.nn.Parameter)
               for _, w in tm.jax_param_paths())
    assert qm.wpe.pos is tm.wpe.pos and qm.blocks[0].fc.bias is \
        tm.blocks[0].fc.bias
    assert "kernel" not in dict(qm.blocks[0].fc.named_parameters())
    assert tquant.quantized_bytes(qm) == jquant.quantized_bytes(jq)
    assert tquant.quantized_bytes(tm) == jquant.quantized_bytes(params)
    assert tquant.quantized_bytes(qm) < 0.45 * tquant.quantized_bytes(tm)


# -- w8a8, the int8 matmul, qmatmul -------------------------------------------

@pytest.mark.parametrize("m,k,n", [(4, 768, 2304), (37, 300, 130),
                                   (256, 256, 512)])
def test_w8a8_bit_exact_f32_and_one_ulp_bf16(m, k, n):
    rng = np.random.default_rng(m)
    w = rng.normal(size=(k, n)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[1] = 0.0                           # an all-zero row: sx = 1
    jw = jqm.quantize_int8(w)
    tw = _to_torch_iw(jw)
    ref = np.asarray(jqm.w8a8_matmul(jnp.asarray(x), jw))
    got = tqm.w8a8_matmul(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    # bf16 x and out: the activation quantizes from the same bf16 values
    xb = torch.from_numpy(x).bfloat16()
    ref = np.asarray(jqm.w8a8_matmul(jnp.asarray(xb.float().numpy())
                                     .astype(jnp.bfloat16), jw)
                     .astype(jnp.float32))
    got = tqm.w8a8_matmul(xb, tw)
    assert got.dtype == torch.bfloat16
    assert (np.abs(got.float().numpy() - ref) <= _bf16_ulp(ref)).all()


@pytest.mark.parametrize("m,k,n,xdtype,out", [
    (300, 768, 2304, "float32", None), (257, 300, 130, "float32", None),
    (300, 768, 2304, "bfloat16", None), (257, 300, 130, "bfloat16", None),
    (260, 256, 512, "bfloat16", "float32"),
    (260, 256, 512, "float32", "float32")])
def test_int8_matmul_plain_matches_jax_kernel(m, k, n, xdtype, out):
    rng = np.random.default_rng(m + k)
    w = rng.normal(size=(k, n)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)) \
        .to(getattr(torch, xdtype))
    jw = jqm.quantize_int8(w)
    tw = _to_torch_iw(jw)
    odt = None if out is None else getattr(torch, out)
    jx = jnp.asarray(x.float().numpy()).astype(xdtype)
    if xdtype == "bfloat16":
        try:
            ref = jqm.int8_matmul(jx, jw.q, jw.scale, n=n, k=k,
                                  out_dtype=None if out is None
                                  else jnp.float32)
        except Exception as e:   # XLA:CPU builds without a bf16 dot
            if "unsupported element type" not in str(e).lower():
                raise
            ref = jqm.int8_matmul(jx.astype(jnp.float32), jw.q, jw.scale,
                                  n=n, k=k).astype(out or jnp.bfloat16)
    else:
        ref = jqm.int8_matmul(jx, jw.q, jw.scale, n=n, k=k)
    ref = np.asarray(ref.astype(jnp.float32))
    before = tqm.int8_matmul.launches
    got = tqm.int8_matmul(x, tw.q, tw.scale, n=n, k=k, out_dtype=odt)
    assert tqm.int8_matmul.launches == before       # CPU: the plain version
    assert got.dtype == (odt or x.dtype) and tuple(got.shape) == (m, n)
    plain = tqm.int8_matmul_reference(x, tw.q, tw.scale, n=n, k=k,
                                      out_dtype=odt)
    assert torch.equal(got, plain)
    diff = np.abs(got.float().numpy() - ref)
    order = 1e-6 * np.abs(ref).max()
    if got.dtype == torch.float32:
        assert diff.max() <= order, diff.max()
    else:
        assert (diff <= _bf16_ulp(ref) + order).all()


def test_qmatmul_dispatch_rank_and_rows_override():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(256, 128)).astype(np.float32)
    jw = jqm.quantize_int8(w)
    tw = _to_torch_iw(jw)
    lim = tqm.W8A8_MAX_ROWS
    assert lim == jqm.W8A8_MAX_ROWS
    x = rng.normal(size=(lim + 1, 256)).astype(np.float32)
    tx = torch.from_numpy(x)
    # at the limit: w8a8, bit for bit as JAX's qmatmul
    np.testing.assert_array_equal(
        tqm.qmatmul(tx[:lim], tw).numpy(),
        np.asarray(jqm.qmatmul(jnp.asarray(x[:lim]), jw)))
    # one row past it: the weight-only kernel, as JAX's (interpret mode)
    ref = np.asarray(jqm.qmatmul(jnp.asarray(x), jw))
    got = tqm.qmatmul(tx, tw)
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    assert torch.equal(got, tqm.int8_matmul(tx, tw.q, tw.scale, n=128,
                                            k=256))
    # rows overrides what the choice reads, not what is computed
    assert torch.equal(tqm.qmatmul(tx[:8], tw, rows=lim + 1),
                       tqm.int8_matmul(tx[:8], tw.q, tw.scale, n=128, k=256))
    assert torch.equal(tqm.qmatmul(tx, tw, rows=8),
                       tqm.w8a8_matmul(tx, tw))
    assert not torch.equal(tqm.qmatmul(tx[:8], tw),
                           tqm.qmatmul(tx[:8], tw, rows=lim + 1))
    # rank: 1-D in -> 1-D out, 3-D in -> 3-D out, on both branches
    assert tuple(tqm.qmatmul(tx[0], tw).shape) == (128,)
    assert tuple(tqm.qmatmul(tx[:6].reshape(2, 3, 256), tw).shape) == \
        (2, 3, 128)
    assert tuple(tqm.qmatmul(tx[:lim].reshape(2, lim // 2, 256), tw,
                             rows=lim + 1).shape) == (2, lim // 2, 128)
    # out_dtype on both branches; float weights: the f32 product
    assert tqm.qmatmul(tx.bfloat16(), tw).dtype == torch.bfloat16
    assert tqm.qmatmul(tx.bfloat16(), tw,
                       out_dtype=torch.float32).dtype == torch.float32
    wf = torch.from_numpy(w)
    np.testing.assert_allclose(tqm.qmatmul(tx, wf).numpy(), x @ w,
                               rtol=1e-5, atol=1e-4)


# -- the quantized GPT-2 ------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16), (3, 96)],
                         ids=["w8a8_32rows", "int8_288rows"])
def test_quantized_gpt2_logits_match_jax_fp32(qpair, shape):
    jm, _, jq, _ = qpair
    tm = GPT2(**QMODEL, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, jq))
    assert sum(isinstance(w, tqm.Int8Weight)
               for _, w in tm.jax_param_paths()) == 9
    ids = np.random.default_rng(shape[1]).integers(
        0, QMODEL["vocab_size"], shape).astype(np.int32)
    ref = np.asarray(jm.apply({"params": jq, "state": {}},
                              jnp.asarray(ids))[0])
    with torch.inference_mode():
        out = tm(torch.from_numpy(ids).long()).numpy()
    err = np.abs(out - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


def _bf16_logit_readings(qpair, shape):
    """Relative L2 distances of the quantized model's logits from the JAX
    model's under MIXED_BF16, on the same int8 weights: (the port under
    MIXED_BF16, the JAX model under FP32)."""
    _, _, jq, _ = qpair
    ids = np.random.default_rng(7).integers(
        0, QMODEL["vocab_size"], shape).astype(np.int32)

    def jax_logits(policy):
        out = JGPT2(**QMODEL, policy=policy).apply(
            {"params": jq, "state": {}}, jnp.asarray(ids))[0]
        return np.asarray(out.astype(jnp.float32), np.float64)

    ref = jax_logits(jdt.MIXED_BF16)
    tm = GPT2(**QMODEL, device="cpu", seed=None)   # MIXED_BF16
    tm.load_jax_params(jax.tree.map(np.asarray, jq))
    with torch.inference_mode():
        port = tm(torch.from_numpy(ids).long()).double().numpy()

    def rel_l2(a):
        return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))

    return rel_l2(port), rel_l2(jax_logits(jdt.FP32))


@pytest.mark.parametrize("shape", [(2, 16), (3, 96)],
                         ids=["w8a8_32rows", "int8_288rows"])
def test_quantized_gpt2_bf16_within_bound(qpair, shape):
    """The port under MIXED_BF16 against the JAX model under MIXED_BF16 on
    the same int8 weights, at a w8a8 shape and at one where every matmul
    takes the weight-only kernel. The bound, 4e-3 relative L2 of the
    logits, lies between two readings (XLA:CPU at the suite's
    ``--xla_backend_optimization_level=0``):

        shape          port      JAX FP32
        32 rows        0         2.62e-2
        288 rows       2.25e-3   7.08e-3

    The JAX model in FP32 is what a port that ran the int8 path in f32
    reads, and it must fall outside. A port whose Dense added the f32 bias
    to the unrounded int8 product reads 1.62e-2 and 5.61e-3. At 32 rows the
    two agree bit for bit (w8a8 is an exact integer product); at 288 rows
    the kernel's f32 sums run in another order than the interpreted Pallas
    kernel's, which flips some bf16 roundings. ``XLA_FLAGS=
    --xla_backend_optimization_level=0 python -m tests.test_torch_quant``
    prints the readings."""
    port, f32 = _bf16_logit_readings(qpair, shape)
    assert port <= 4e-3 < f32, (port, f32)


def test_quantized_generate_and_load_checks():
    tm = GPT2(**QMODEL, policy=tdt.FP32, device="cpu", seed=3)
    qm = tquant.quantize_for_decode(tm)
    from tnn_tpu_torch.models.gpt2 import generate

    ids = torch.arange(8)[None]
    toks = generate(qm, ids, 6)
    assert tuple(toks.shape) == (1, 6)
    with pytest.raises(ValueError, match="int8 shape"):
        GPT2(**dict(QMODEL, d_model=128, num_heads=2), device="cpu",
             seed=None).load_jax_params(
            {"wte": {"table": jqm.quantize_int8(
                np.ones((256, 512), np.float32))}})


if __name__ == "__main__":
    # the bf16 readings test_quantized_gpt2_bf16_within_bound quotes
    jm = JGPT2(**QMODEL, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(0), (2, 16))["params"]
    pair = (jm, params, jquant.quantize_for_decode(params), None)
    for shape in ((2, 16), (3, 96)):
        print("%d rows: port %.3g, JAX FP32 %.3g"
              % (shape[0] * shape[1], *_bf16_logit_readings(pair, shape)))
