"""Port parity: the GPT-2 layers on the serving path.

Each torch layer gets the JAX layer's parameters (numpy-seeded) and the same
inputs. Under the FP32 policy the two agree to 1e-5 (summation order only).
Under the bf16 policy the port is held against the JAX layer run in FP32 on
the same bf16-rounded inputs (not every XLA:CPU build runs a bf16 x bf16 ->
f32 dot), to the bound each test states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.nn.attention import MultiHeadAttention as JMHA
from tnn_tpu.nn.embedding import Embedding as JEmbedding
from tnn_tpu.nn.embedding import PositionalEmbedding as JPos
from tnn_tpu.nn.layers import Dense as JDense
from tnn_tpu.nn.norms import LayerNorm as JLayerNorm
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.nn.attention import MultiHeadAttention
from tnn_tpu_torch.nn.embedding import Embedding, PositionalEmbedding
from tnn_tpu_torch.nn.layers import Dense
from tnn_tpu_torch.nn.norms import LayerNorm

POLICIES = {"fp32": tdt.FP32, "bf16": tdt.MIXED_BF16}
FP32_TOL = 1e-5


def _rand(seed, *shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _load(module, params):
    with torch.no_grad():
        for name, value in params.items():
            getattr(module, name).copy_(torch.tensor(np.asarray(value)))


def _input(x, policy):
    """The torch input in the compute dtype, and the f32 numpy array of
    exactly those values for the JAX side."""
    t = torch.from_numpy(x).to(POLICIES[policy].compute_dtype)
    return t, t.float().numpy()


def _check(out, ref, policy, bf16_atol):
    atol = FP32_TOL if policy == "fp32" else bf16_atol
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref),
                               atol=atol, rtol=FP32_TOL)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_layernorm(policy):
    """bf16: output rounded to bf16, |y| < 8 -> 2**-8 * 8 = 3.2e-2."""
    x, xj = _input(_rand(0, 2, 5, 32, scale=2.0, shift=3.0), policy)
    params = {"scale": _rand(1, 32, shift=1.0), "bias": _rand(2, 32)}
    ref, _ = JLayerNorm(policy=jdt.FP32).apply({"params": params},
                                               jnp.asarray(xj))
    ln = LayerNorm(32, policy=POLICIES[policy], device="cpu")
    _load(ln, params)
    out = ln(x)
    assert out.dtype == x.dtype
    _check(out, ref, policy, bf16_atol=3.2e-2)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_dense_gelu(policy):
    """bf16: the kernel is rounded to bf16 (2**-9 relative per weight over
    32 inputs) and the output to bf16 -> 3e-2 on outputs of magnitude < 4."""
    x, xj = _input(_rand(3, 2, 5, 32), policy)
    params = {"kernel": _rand(4, 32, 64, scale=0.3), "bias": _rand(5, 64)}
    dense = Dense(32, 64, activation="gelu", policy=POLICIES[policy],
                  device="cpu")
    _load(dense, params)
    # the weights the port computes with: the master cast at use
    wj = np.asarray(dense.policy.cast_param(dense.kernel).detach().float())
    ref, _ = JDense(64, activation="gelu", policy=jdt.FP32).apply(
        {"params": {"kernel": wj, "bias": params["bias"]}}, jnp.asarray(xj))
    _check(dense(x), ref, policy, bf16_atol=3e-2)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_embedding_and_tied_attend(policy):
    table = _rand(6, 50, 32, scale=0.5)
    ids = np.random.default_rng(7).integers(0, 50, (2, 6)).astype(np.int32)
    emb = Embedding(50, 32, policy=POLICIES[policy], device="cpu")
    _load(emb, {"table": table})
    tj = np.asarray(emb.policy.cast_param(emb.table).detach().float())
    jemb = JEmbedding(50, 32, policy=jdt.FP32)
    rows, _ = jemb.apply({"params": {"table": tj}}, jnp.asarray(ids))
    out = emb(torch.from_numpy(ids).long())
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(rows))
    x, xj = _input(_rand(8, 2, 6, 32), policy)
    logits = emb.attend(x)
    assert logits.dtype == torch.float32
    ref = jemb.attend({"table": tj}, jnp.asarray(xj))
    _check(logits, ref, policy, bf16_atol=1e-5 * 32)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_positional_embedding_per_row_offsets(policy):
    pos = _rand(9, 40, 16)
    x, xj = _input(_rand(10, 3, 5, 16), policy)
    pe = PositionalEmbedding(40, 16, policy=POLICIES[policy], device="cpu")
    _load(pe, {"pos": pos})
    pj = np.asarray(pe.policy.cast_param(pe.pos).detach().float())
    jpe = JPos(40, policy=jdt.FP32)
    offsets = np.array([0, 7, 35], np.int32)
    ref, _ = jpe.apply({"params": {"pos": pj}}, jnp.asarray(xj),
                       offset=jnp.asarray(offsets))
    out = pe(x, offset=torch.from_numpy(offsets))
    _check(out, ref, policy, bf16_atol=2 ** -6)   # one bf16 add rounding
    ref0, _ = jpe.apply({"params": {"pos": pj}}, jnp.asarray(xj), offset=3)
    _check(pe(x, offset=3), ref0, policy, bf16_atol=2 ** -6)


def _mha_pair(policy, *, heads=4, kv_heads=2, d=32, seed=0):
    jm = JMHA(heads, causal=True, num_kv_heads=kv_heads, policy=jdt.FP32)
    params = jax.tree.map(np.asarray,
                          jm.init(jax.random.PRNGKey(seed), (1, 8, d))
                          ["params"])
    params = {k: v + _rand(seed + 1, *v.shape, scale=0.1) if "bias" in k
              else v for k, v in params.items()}
    tm = MultiHeadAttention(d, heads, num_kv_heads=kv_heads,
                            policy=POLICIES[policy], device="cpu")
    _load(tm, params)
    # the JAX side computes with the values the port casts its masters to
    params = {k: np.asarray(tm.policy.cast_param(getattr(tm, k)).detach()
                            .float()) for k in params}
    return jm, params, tm


@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa2"])
def test_attention_whole_sequence(heads):
    jm, params, tm = _mha_pair("fp32", heads=heads[0], kv_heads=heads[1])
    x = _rand(11, 2, 7, 32)
    ref, _ = jm.apply({"params": params}, jnp.asarray(x))
    _check(tm(torch.from_numpy(x)), ref, "fp32", None)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("form", ["decode", "chunk"])
def test_attention_apply_paged(form, policy):
    """Outputs of live tokens and every live page agree; bf16 rounds
    activations, pages and outputs to bf16 (2**-8 relative on values < 4)."""
    jm, params, tm = _mha_pair(policy)
    rng = np.random.default_rng(12)
    bs, dh, hkv = 4, 8, 2
    cd = POLICIES[policy].compute_dtype
    pages = [torch.from_numpy(_rand(s, 2, 16, hkv, bs, dh)).to(cd)
             for s in (13, 14)]
    tables = np.array([[3, 4, 5, 0], [6, 7, 0, 0], [8, 9, 10, 11]], np.int32)
    offsets = np.array([5, 0, 9], np.int32)
    if form == "decode":
        q_lens, qw = None, 1
    else:
        q_lens, qw = np.array([3, 6, 1], np.int32), 6
    x, xj = _input(rng.normal(size=(3, qw, 32)).astype(np.float32), policy)
    jpk, jpv = (jnp.asarray(p.float().numpy()) for p in pages)
    jy, jpk, jpv = jm.apply_paged(
        {"params": params}, jnp.asarray(xj), jpk, jpv, jnp.asarray(tables),
        jnp.asarray(offsets), layer=1,
        q_lens=None if q_lens is None else jnp.asarray(q_lens))
    y = tm.apply_paged(x, pages[0], pages[1], torch.from_numpy(tables),
                       torch.from_numpy(offsets), layer=1,
                       q_lens=None if q_lens is None
                       else torch.from_numpy(q_lens))
    live = np.ones((3, qw), bool) if q_lens is None \
        else np.arange(qw)[None] < q_lens[:, None]
    _check(y[torch.from_numpy(live)], np.asarray(jy)[live], policy,
           bf16_atol=3e-2)
    for mine, ref in zip(pages, (jpk, jpv)):
        _check(mine[:, 1:], np.asarray(ref)[:, 1:], policy, bf16_atol=3e-2)
