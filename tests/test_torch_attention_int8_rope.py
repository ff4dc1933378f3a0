"""Port parity: the per-model int8 contiguous KV cache (``kv_cache_dtype=
"int8"``) and RoPE in ``MultiHeadAttention.apply_paged``.

- ``init_cache`` / ``apply_cached`` with an int8 cache at scalar and per-row
  offsets, under FP32: the int8 codes equal JAX's byte for byte, the f32
  scales within 1e-6, the outputs within 1e-5, for plain and rotary GQA
  layers.
- ``generate`` over the int8 cache on a 2L/256d GPT-2 and a 2L/128d GQA
  Llama, token-exact against the JAX package's ``generate`` on tie-free
  seeds (each emitted token leads its runner-up by more than 1e-3 in the
  port's own int8-cache logits). Tiny models quantize little, hence the
  widths.
- The config round trip: ``get_config()`` equals JAX's, and
  ``module_from_config`` builds the int8-cache model again.
- ``apply_paged`` with RoPE on a 4 q / 2 kv-head layer, decode and chunk
  forms, per-row offsets, against JAX's ``apply_paged`` (FP32, 1e-5).
- The engine refuses an int8-cache model with the JAX message.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.models.gpt2 import generate as jgenerate
from tnn_tpu.models.llama import Llama as JLlama
from tnn_tpu.nn.attention import MultiHeadAttention as JMHA
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.core.module import module_from_config
from tnn_tpu_torch.models.gpt2 import GPT2, generate
from tnn_tpu_torch.models.llama import Llama
from tnn_tpu_torch.nn.attention import MultiHeadAttention
from tnn_tpu_torch.serving.engine import InferenceEngine

OUT_TOL = 1e-5
SCALE_TOL = 1e-6
MARGIN = 1e-3


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _mha_pair(*, heads=4, kv_heads=2, d=32, rope=None, int8=True, seed=0):
    """A JAX and a port layer with the same FP32 weights (biases made
    nonzero, as ``tests/test_torch_layers.py`` does)."""
    kv = "int8" if int8 else None
    jm = JMHA(heads, causal=True, num_kv_heads=kv_heads, policy=jdt.FP32,
              rope_theta=rope, kv_cache_dtype=kv)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed),
                                              (1, 8, d))["params"])
    params = {k: v + _rand(seed + 1, *v.shape, scale=0.1) if "bias" in k
              else v for k, v in params.items()}
    tm = MultiHeadAttention(d, heads, num_kv_heads=kv_heads, rope_theta=rope,
                            kv_cache_dtype=kv, policy=tdt.FP32, device="cpu")
    with torch.no_grad():
        for name, value in params.items():
            getattr(tm, name).copy_(torch.tensor(value))
    return jm, params, tm


def _check_cache(tcache, jcache):
    for name in ("k", "v"):
        mine, ref = tcache[name].numpy(), np.asarray(jcache[name])
        assert mine.dtype == np.int8 and ref.dtype == np.int8
        np.testing.assert_array_equal(mine, ref)
        np.testing.assert_allclose(tcache[name + "_scale"].detach().numpy(),
                                   np.asarray(jcache[name + "_scale"]),
                                   rtol=0, atol=SCALE_TOL)


@pytest.mark.parametrize("rope", [None, 10000.0], ids=["plain", "rope"])
def test_int8_cache_apply_cached_matches_jax(rope):
    """A 5-token prefill at scalar offset 0, then a ragged decode token at
    per-row offsets, then a 2-token scalar step, all on one int8 cache."""
    jm, params, tm = _mha_pair(rope=rope)
    variables = {"params": params}
    batch, max_len, d = 3, 16, 32
    jcache = jm.init_cache(batch, max_len, d)
    tcache = tm.init_cache(batch, max_len)
    assert tcache["k"].dtype == torch.int8
    assert tcache["k_scale"].dtype == torch.float32
    assert tuple(tcache["k_scale"].shape) == (batch, 2, max_len, 1)
    steps = [(_rand(11, batch, 5, d), 0),
             (_rand(12, batch, 1, d), np.array([5, 3, 4], np.int32)),
             (_rand(13, batch, 2, d), 6)]
    for x, off in steps:
        toff = torch.from_numpy(off) if isinstance(off, np.ndarray) else off
        joff = jnp.asarray(off) if isinstance(off, np.ndarray) else off
        ref, jcache = jm.apply_cached(variables, jnp.asarray(x), jcache,
                                      joff)
        out, tcache = tm.apply_cached(torch.from_numpy(x), tcache, toff)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=OUT_TOL)
        _check_cache(tcache, jcache)


def _greedy_gaps(model, prompt, max_new):
    """The port's own greedy decode over its int8 cache: (tokens, the top-2
    gap of each emitted token's logits)."""
    caches = model.init_cache(1, len(prompt) + max_new)
    ids = torch.from_numpy(np.asarray(prompt)[None]).long()
    logits = model.apply_cached(ids, caches, 0)[:, -1]
    toks, gaps = [], []
    with torch.inference_mode():
        for i in range(max_new):
            top2 = logits[0].topk(2).values
            gaps.append(float(top2[0] - top2[1]))
            tok = int(logits[0].argmax())
            toks.append(tok)
            logits = model.apply_cached(torch.tensor([[tok]]), caches,
                                        len(prompt) + i)[:, -1]
    return toks, gaps


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_generate_over_int8_cache_matches_jax(arch):
    if arch == "gpt2":
        cfg = dict(vocab_size=256, max_len=64, num_layers=2, d_model=256,
                   num_heads=4, kv_cache_dtype="int8")
        jm, tcls = JGPT2(**cfg, policy=jdt.FP32), GPT2
    else:
        cfg = dict(vocab_size=257, max_len=64, num_layers=2, d_model=128,
                   num_heads=4, num_kv_heads=2, kv_cache_dtype="int8")
        jm, tcls = JLlama(**cfg, policy=jdt.FP32), Llama
    params = jm.init(jax.random.PRNGKey(1), (1, 8))["params"]
    tm = tcls(**cfg, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    # prompt seed 6 is tie-free for both (seed 4's Llama stream has a 9.5e-4
    # gap, under the suite's XLA flags)
    prompt = np.random.default_rng(6).integers(0, cfg["vocab_size"], 9) \
        .astype(np.int32)
    max_new = 12
    ref = np.asarray(jgenerate(jm, params, jnp.asarray(prompt[None]),
                               max_new, max_len=len(prompt) + max_new))[0]
    got = generate(tm, torch.from_numpy(prompt), max_new)[0].numpy()
    toks, gaps = _greedy_gaps(tm, prompt, max_new)
    assert min(gaps) > MARGIN, gaps          # the seed is tie-free
    assert toks == got.tolist()
    np.testing.assert_array_equal(got, ref)
    assert tm.blocks[0].attn.init_cache(1, 4)["k"].dtype == torch.int8


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_int8_cache_config_round_trips(arch):
    if arch == "gpt2":
        cfg = dict(vocab_size=64, max_len=32, num_layers=1, d_model=32,
                   num_heads=2, kv_cache_dtype="int8")
        jm, tm = JGPT2(**cfg, policy=jdt.FP32), GPT2(
            **cfg, policy=tdt.FP32, device="cpu", seed=0)
    else:
        cfg = dict(vocab_size=64, max_len=32, num_layers=1, d_model=32,
                   num_heads=4, num_kv_heads=2, kv_cache_dtype="int8")
        jm, tm = JLlama(**cfg, policy=jdt.FP32), Llama(
            **cfg, policy=tdt.FP32, device="cpu", seed=0)
    assert tm.get_config() == jm.get_config()
    again = module_from_config(tm.get_config(), device="cpu")
    assert again.get_config() == tm.get_config()
    assert all(b.attn.kv_cache_dtype == "int8" for b in again.blocks)
    plain = module_from_config({**tm.get_config(), "kv_cache_dtype": None},
                               device="cpu")
    assert "kv_cache_dtype" not in plain.get_config()


def test_int8_cache_flash_backend_uses_kv_offset_form():
    """On a "pallas" (flash) model the dequantized cache goes through the
    flash wrapper with ``kv_offset`` at a scalar offset (K4 on the card; its
    plain version here), as a float cache does; the result equals the
    "xla" backend's on the same cache."""
    from tnn_tpu_torch.ops import flash_attention as fa

    _, params, tm = _mha_pair(rope=10000.0)
    flash = MultiHeadAttention(32, 4, num_kv_heads=2, rope_theta=10000.0,
                               kv_cache_dtype="int8", backend="pallas",
                               policy=tdt.FP32, device="cpu")
    flash.load_state_dict(tm.state_dict())
    calls = []
    real = fa.flash_attention

    def spy(*a, **kw):
        calls.append(kw.get("kv_offset"))
        return real(*a, **kw)

    fa.flash_attention = spy
    try:
        outs = []
        for layer in (tm, flash):
            cache = layer.init_cache(2, 12)
            layer.apply_cached(torch.from_numpy(_rand(21, 2, 4, 32)), cache,
                               0)
            y, _ = layer.apply_cached(torch.from_numpy(_rand(22, 2, 1, 32)),
                                      cache, 4)
            outs.append(y)
    finally:
        fa.flash_attention = real
    assert calls == [0, 4]
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=OUT_TOL)


@pytest.mark.parametrize("form", ["decode", "chunk"])
def test_apply_paged_rope_gqa_matches_jax(form):
    """Rotary GQA (4 q / 2 kv heads) straight against the pages: q and the
    new keys rotate at offsets + arange(Q), per row, as in JAX."""
    jm, params, tm = _mha_pair(rope=10000.0, int8=False, seed=3)
    bs, dh, hkv = 4, 8, 2
    pages = [torch.from_numpy(_rand(s, 2, 16, hkv, bs, dh)) for s in (13, 14)]
    tables = np.array([[3, 4, 5, 0], [6, 7, 0, 0], [8, 9, 10, 11]], np.int32)
    offsets = np.array([5, 0, 9], np.int32)
    if form == "decode":
        q_lens, qw = None, 1
    else:
        q_lens, qw = np.array([3, 6, 1], np.int32), 6
    x = _rand(15, 3, qw, 32)
    jpk, jpv = (jnp.asarray(p.numpy()) for p in pages)
    jy, jpk, jpv = jm.apply_paged(
        {"params": params}, jnp.asarray(x), jpk, jpv, jnp.asarray(tables),
        jnp.asarray(offsets), layer=1,
        q_lens=None if q_lens is None else jnp.asarray(q_lens))
    y = tm.apply_paged(torch.from_numpy(x), pages[0], pages[1],
                       torch.from_numpy(tables), torch.from_numpy(offsets),
                       layer=1, q_lens=None if q_lens is None
                       else torch.from_numpy(q_lens))
    live = np.ones((3, qw), bool) if q_lens is None \
        else np.arange(qw)[None] < q_lens[:, None]
    np.testing.assert_allclose(y.detach().numpy()[live], np.asarray(jy)[live],
                               rtol=0, atol=OUT_TOL)
    for mine, ref in zip(pages, (jpk, jpv)):
        np.testing.assert_allclose(mine[:, 1:].detach().numpy(),
                                   np.asarray(ref)[:, 1:], rtol=0,
                                   atol=OUT_TOL)


def test_apply_paged_rope_equals_apply_cached():
    """The paged form's rotated keys are the cached form's: a chunk through
    the pages gives the outputs ``apply_cached`` gives over a contiguous
    cache at the same per-row offsets."""
    _, _, tm = _mha_pair(rope=10000.0, int8=False, seed=5)
    bs, q, prior = 4, 3, np.array([2, 6], np.int32)
    tables = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    pk = torch.zeros(1, 8, 2, bs, 8)
    pv = torch.zeros(1, 8, 2, bs, 8)
    cache = tm.init_cache(2, 12)
    x0 = torch.from_numpy(_rand(31, 2, 6, 32))
    x1 = torch.from_numpy(_rand(32, 2, q, 32))
    # the prior tokens into both caches, then the chunk
    tm.apply_paged(x0, pk, pv, tables, torch.zeros(2, dtype=torch.int32),
                   q_lens=torch.from_numpy(prior))
    tm.apply_cached(x0, cache, 0)
    y_paged = tm.apply_paged(x1, pk, pv, tables, torch.from_numpy(prior),
                             q_lens=torch.full((2,), q, dtype=torch.int32))
    y_cached, _ = tm.apply_cached(x1, cache, torch.from_numpy(prior))
    torch.testing.assert_close(y_paged, y_cached, rtol=0, atol=OUT_TOL)


def test_engine_refuses_an_int8_cache_model():
    tm = GPT2(vocab_size=64, max_len=32, num_layers=1, d_model=32,
              num_heads=2, kv_cache_dtype="int8", policy=tdt.FP32,
              device="cpu", seed=0)
    with pytest.raises(ValueError, match="quantize the POOL instead"):
        InferenceEngine(tm, device="cpu", num_blocks=8, block_size=4)
    with pytest.raises(NotImplementedError, match="int8 KV pages"):
        tm.blocks[0].attn.apply_paged(
            torch.zeros(1, 1, 32), torch.zeros(1, 4, 2, 4, 16),
            torch.zeros(1, 4, 2, 4, 16), torch.zeros(1, 2, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))
