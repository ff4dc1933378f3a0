"""Port parity: GPT-2 forwards after ``load_jax_params``.

The tiny GPT-2 (and its GQA twin) from the JAX package, its parameter tree
carried across as numpy, and the same token inputs: whole-sequence logits
(``apply`` vs ``forward``), a ragged prefill step (``apply_paged``) and a
decode step (``apply_decode_paged``) against the paged pool, comparing
logits at live positions and every non-scratch page.

Under FP32 the logits agree to 1e-5 relative to the largest logit. Under
the bf16 policy the port is held against the JAX model in FP32 (not every
XLA:CPU build runs a bf16 x bf16 -> f32 dot) with 5e-2 of the largest logit:
two layers of bf16 activations, each rounded to 8 bits of mantissa.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models import zoo
from tnn_tpu_torch.models.gpt2 import GPT2

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
POLICIES = {"fp32": tdt.FP32, "bf16": tdt.MIXED_BF16}
REL_TOL = {"fp32": 1e-5, "bf16": 5e-2}


def _pair(policy, num_kv_heads=None, seed=0):
    """The JAX model in FP32 and the port under ``policy``, same weights."""
    kw = dict(TINY, num_kv_heads=num_kv_heads) if num_kv_heads else TINY
    jm = JGPT2(**kw, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(seed), (1, 8))["params"]
    tm = GPT2(**kw, policy=POLICIES[policy], device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


def _close(out, ref, policy):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy()
    err = np.abs(out - ref).max()
    assert err <= REL_TOL[policy] * np.abs(ref).max(), err


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("kv_heads", [None, 1], ids=["mha", "gqa"])
def test_apply_logits(policy, kv_heads):
    jm, params, tm = _pair(policy, kv_heads)
    ids = np.random.default_rng(1).integers(0, 128, (2, 12)).astype(np.int32)
    ref, _ = jm.apply({"params": params}, jnp.asarray(ids))
    out = tm(torch.from_numpy(ids).long())
    assert out.dtype == torch.float32 and out.shape == (2, 12, 128)
    _close(out, ref, policy)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("kv_heads", [None, 1], ids=["mha", "gqa"])
def test_paged_prefill_then_decode(policy, kv_heads):
    jm, params, tm = _pair(policy, kv_heads)
    rng = np.random.default_rng(2)
    bs, nb, b, qw = 4, 5, 3, 8
    hkv = kv_heads or TINY["num_heads"]
    dh = TINY["d_model"] // TINY["num_heads"]
    shape = (TINY["num_layers"], 16, hkv, bs, dh)
    tables = np.array([[1, 2, 3, 0, 0], [4, 5, 6, 7, 0], [8, 9, 0, 0, 0]],
                      np.int32)
    q_lens = np.array([8, 5, 2], np.int32)
    starts = np.array([0, 6, 1], np.int32)   # rows 1, 2 resume earlier KV
    toks = rng.integers(0, 128, (b, qw)).astype(np.int32)
    pages0 = rng.normal(size=shape).astype(np.float32) * 0.5
    cd = POLICIES[policy].compute_dtype
    pk = torch.from_numpy(pages0).to(cd)
    pv = torch.from_numpy(pages0[::-1].copy()).to(cd)
    jpk = jnp.asarray(pk.float().numpy())
    jpv = jnp.asarray(pv.float().numpy())
    t = [torch.from_numpy(a) for a in (toks, tables, starts, q_lens)]

    ref, jpk, jpv = jm.apply_paged(params, *map(jnp.asarray, (
        toks, jpk, jpv, tables, starts, q_lens)))
    out = tm.apply_paged(t[0], pk, pv, t[1], t[2], t[3])
    live = np.arange(qw)[None] < q_lens[:, None]
    _close(out[torch.from_numpy(live)], np.asarray(ref)[live], policy)
    last = tm.apply_paged(t[0], pk.clone(), pv.clone(), t[1], t[2], t[3],
                          last_only=True)
    _close(last, np.asarray(ref)[np.arange(b), q_lens - 1], policy)
    for mine, theirs in ((pk, jpk), (pv, jpv)):
        _close(mine[:, 1:], np.asarray(theirs)[:, 1:], policy)

    # one decode step on top of the prefill
    nxt = rng.integers(0, 128, (b,)).astype(np.int32)
    offsets = starts + q_lens
    ref, jpk, jpv = jm.apply_decode_paged(params, *map(jnp.asarray, (
        nxt, jpk, jpv, tables, offsets)))
    out = tm.apply_decode_paged(torch.from_numpy(nxt), pk, pv, t[1],
                                torch.from_numpy(offsets))
    assert out.shape == (b, 128)
    _close(out, ref, policy)
    for mine, theirs in ((pk, jpk), (pv, jpv)):
        _close(mine[:, 1:], np.asarray(theirs)[:, 1:], policy)


def test_seeded_init_is_deterministic_and_load_checks_shapes():
    a = GPT2(**TINY, device="cpu", seed=3)
    b = GPT2(**TINY, device="cpu", seed=3)
    c = GPT2(**TINY, device="cpu", seed=4)
    ids = torch.arange(10)[None]
    assert torch.equal(a(ids), b(ids))
    assert not torch.equal(a(ids), c(ids))
    assert a.wte.table.dtype == torch.float32           # f32 master
    assert a.wte(ids).dtype == torch.bfloat16            # cast at use
    assert a.blocks[0].ln1.scale.dtype == torch.float32  # read in f32
    with pytest.raises(ValueError, match="shape"):
        a.load_jax_params({"wte": {"table": np.zeros((3, 3))}})


@pytest.mark.parametrize("name,layers,d,heads,kv_heads", [
    ("gpt2_tiny", 2, 128, 2, 2), ("gpt2_small", 12, 768, 12, 12),
    ("gpt2_small_hd128", 12, 768, 6, 6), ("gpt2_small_gqa4", 12, 768, 12, 4),
])
def test_zoo_geometry(name, layers, d, heads, kv_heads):
    m = zoo.create(name, device="meta", seed=None)
    assert (m.num_layers, m.d_model, m.num_heads, m.num_kv_heads) == \
        (layers, d, heads, kv_heads)
    assert (m.vocab_size, m.max_len) == (50257, 1024)
    qkv = m.blocks[0].attn.qkv_kernel
    assert tuple(qkv.shape) == (d, d + 2 * kv_heads * (d // heads))
