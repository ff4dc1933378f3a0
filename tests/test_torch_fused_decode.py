"""Port parity: ``models/fused_decode.py`` (the glue around K8).

- ``stack_decode_weights`` equals JAX's stacks leaf by leaf, bit for bit
  (the port's ``quantize_for_decode`` is JAX's bit for bit,
  ``tests/test_torch_quant.py``).
- ``caches_to_stacked`` equals JAX's; ``pick_chunks`` equals JAX's on a
  grid of (d, F, B, T), ``None`` included.
- The refusals: float weights, weights that carry padding, grouped-query
  attention, an int8 cache, MoE blocks.
- Greedy ``fused_generate`` is token-exact against JAX's
  ``fused_generate(interpret=True)`` under FP32 on seeds checked tie-free:
  every emitted token beats the runner-up logit by more than 1e-3 in the
  port's own teacher-forced logits.
- Teacher-forced per-step logits against JAX's kernel in interpret mode:
  both compute at the same rounding points (no code differs on this model,
  ``test_torch_decode_stack.py``), so they agree to float rounding through
  ln_f and the int8 head: 1e-5 of max|logits| (reading: 3.0e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models import fused_decode as jfd
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.nn.quant import quantize_for_decode as jquant
from tnn_tpu.ops.pallas.decode_stack import fused_decode_stack as jk8
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models import fused_decode as tfd
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.nn.quant import quantize_for_decode
from tnn_tpu_torch.ops.decode_stack import fused_decode_stack

SMALL = dict(vocab_size=512, max_len=64, num_layers=2, d_model=256,
             num_heads=4)
MARGIN = 1e-3


def _pair(cfg, seed=0):
    jm = JGPT2(**cfg, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(seed), (1, 8))["params"]
    tm = GPT2(**cfg, policy=tdt.FP32, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def small():
    jm, params, tm = _pair(SMALL)
    return jm, jquant(params), quantize_for_decode(tm)


def test_stacks_equal_jax_bit_for_bit(small):
    jm, jq, qm = small
    want = jfd.stack_decode_weights(jm, jq)
    got = tfd.stack_decode_weights(qm)
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    assert tfd.decode_stacks(qm) is tfd.decode_stacks(qm)   # built once


def test_caches_to_stacked_equals_jax():
    rng = np.random.default_rng(0)
    caches = [{"k": rng.normal(size=(2, 4, 16, 8)).astype(np.float32),
               "v": rng.normal(size=(2, 4, 16, 8)).astype(np.float32)}
              for _ in range(3)]
    jk, jv = jfd.caches_to_stacked(
        [{n: jnp.asarray(a) for n, a in c.items()} for c in caches])
    tk, tv = tfd.caches_to_stacked(
        [{n: torch.from_numpy(a) for n, a in c.items()} for c in caches])
    assert tk.shape == (3, 2, 16, 32) and tk.is_contiguous()
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_pick_chunks_equals_jax_on_a_grid():
    seen = set()
    for d in (128, 256, 768, 1024, 1280):
        for f in (4 * d, 3 * d, 4 * d + 4):
            for b in (1, 2, 3, 4, 8):
                for t in (64, 192, 512, 1024, 2048):
                    got = tfd.pick_chunks(d, f, b, t)
                    assert got == jfd.pick_chunks(d, f, b, t), (d, f, b, t)
                    seen.add(got)
    assert seen == {1, 2, 4, 8, None}
    assert tfd.pick_chunks(768, 3072, 2, 1024) == 4     # the engine's
    assert tfd.pick_chunks(768, 3072, 4, 1024) is None
    assert tfd.pick_chunks(768, 3072, 1, 1024, cache_bytes=4) == \
        jfd.pick_chunks(768, 3072, 1, 1024, cache_bytes=4)


def test_refusals_match_jax():
    # float weights, and a model whose matmuls are too small to quantize
    _, _, tm = _pair(SMALL)
    with pytest.raises(ValueError, match="int8"):
        tfd.stack_decode_weights(tm)
    narrow = quantize_for_decode(GPT2(vocab_size=128, max_len=32,
                                      num_layers=1, d_model=32, num_heads=2,
                                      device="cpu"))
    with pytest.raises(ValueError, match="int8"):
        tfd.stack_decode_weights(narrow)
    # 192 quantizes (both dims >= 128) but pads to 256
    cfg = dict(vocab_size=128, max_len=32, num_layers=1, d_model=192,
               num_heads=3)
    jm, params, tm = _pair(cfg)
    with pytest.raises(ValueError, match="padding"):
        jfd.stack_decode_weights(jm, jquant(params))
    with pytest.raises(ValueError, match="padding"):
        tfd.stack_decode_weights(quantize_for_decode(tm))
    # grouped-query attention (gpt2_small_gqa4's ratio at tiny width)
    cfg = dict(vocab_size=128, max_len=32, num_layers=1, d_model=256,
               num_heads=4, num_kv_heads=2)
    jm, params, tm = _pair(cfg)
    with pytest.raises(ValueError, match="grouped-query"):
        jfd.stack_decode_weights(jm, jquant(params))
    with pytest.raises(ValueError, match="grouped-query"):
        tfd.stack_decode_weights(quantize_for_decode(tm))


def test_refuses_int8_cache_and_moe_blocks(small):
    """The port's GPT2 has neither an int8 per-model cache nor MoE blocks
    yet; the refusals read them as the JAX glue does (an attribute on the
    model, a ``moe`` member of a block)."""
    _, _, qm = small
    m8 = quantize_for_decode(qm)
    m8.kv_cache_dtype = "int8"
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tfd.stack_decode_weights(m8)
    moe = quantize_for_decode(qm)
    moe.blocks[1].moe = torch.nn.Identity()
    with pytest.raises(ValueError, match="MoE"):
        tfd.stack_decode_weights(moe)


def _teacher_forced(qm, stream, p, chunks):
    """The port's fused decode over a fixed token stream (fused_generate's
    body): per-step logits."""
    stacks = tfd.stack_decode_weights(qm)
    caches = qm.init_cache(stream.shape[0], stream.shape[1])
    with torch.inference_mode():
        out = [qm.apply_cached(stream[:, :p], caches, 0)[:, -1]]
        kc, vc = tfd.caches_to_stacked(caches)
        for pos in range(p, stream.shape[1] - 1):
            x = qm.wpe(qm.wte(stream[:, pos:pos + 1]), offset=pos)[:, 0]
            x_out, kc, vc = fused_decode_stack(
                x, pos, kc, vc, stacks, num_heads=qm.num_heads,
                chunks=chunks)
            out.append(qm._head(x_out[:, None, :])[:, -1])
    return torch.stack(out, dim=1)


def test_teacher_forced_logits_match_jax(small):
    jm, jq, qm = small
    rs = np.random.RandomState(1)
    b, p, steps = 2, 6, 4
    stream = rs.randint(0, 512, (b, p + steps)).astype(np.int32)
    got = _teacher_forced(qm, torch.from_numpy(stream).long(), p, 2)
    stacks = jfd.stack_decode_weights(jm, jq)
    caches = jm.init_cache(b, p + steps)
    logits, caches = jm.apply_cached(jq, jnp.asarray(stream[:, :p]),
                                     caches, 0)
    want = [np.asarray(logits[:, -1])]
    kc, vc = jfd.caches_to_stacked(caches)
    for pos in range(p, p + steps - 1):
        tok = jnp.asarray(stream[:, pos:pos + 1])
        x, _ = jm.wte.apply({"params": jq["wte"], "state": {}}, tok)
        x, _ = jm.wpe.apply({"params": jq["wpe"], "state": {}}, x,
                            offset=pos)
        x_out, kc, vc = jk8(x[:, 0], jnp.asarray(pos, jnp.int32), kc, vc,
                            stacks, num_heads=jm.num_heads, chunks=2,
                            interpret=True)
        xf, _ = jm.ln_f.apply({"params": jq["ln_f"], "state": {}},
                              x_out[:, None, :])
        want.append(np.asarray(jm._head(jq, xf)[:, -1]))
    want = np.stack(want, axis=1)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


@pytest.mark.parametrize("seed", [2, 3])
def test_greedy_fused_generate_token_exact_vs_jax(small, seed):
    jm, jq, qm = small
    rs = np.random.RandomState(seed)
    prompt = rs.randint(0, 512, (2, 8)).astype(np.int32)
    n = 5
    want = np.asarray(jfd.fused_generate(jm, jq, jnp.asarray(prompt), n,
                                         interpret=True))
    got = tfd.fused_generate(qm, torch.from_numpy(prompt), n)
    assert got.shape == (2, n) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # tie-free: the port's logits along the emitted stream
    stream = torch.cat([torch.from_numpy(prompt).long(), got], dim=1)
    logits = _teacher_forced(qm, stream, 8, tfd.pick_chunks(
        256, 1024, 2, 8 + n))
    top2 = logits.topk(2, dim=-1).values
    assert torch.equal(logits.argmax(-1), got)
    gap = (top2[..., 0] - top2[..., 1]).min().item()
    assert gap > MARGIN, gap
    # deterministic across calls; the stacks are built once per model
    assert torch.equal(tfd.fused_generate(qm, torch.from_numpy(prompt), n),
                       got)


def test_fused_generate_counts_one_launch_per_token_on_card():
    """On CPU tensors the plain version runs and nothing counts; the
    launch count (``max_new_tokens - 1`` per call) is read on the card by
    chip_smoke.py. Here: the call's contract and its refusals."""
    _, _, tm = _pair(SMALL)
    with pytest.raises(ValueError, match="int8"):
        tfd.fused_generate(tm, torch.zeros((1, 4), dtype=torch.long), 2)
    qm = quantize_for_decode(tm)
    with pytest.raises(ValueError, match="max_len"):
        tfd.fused_generate(qm, torch.zeros((1, 60), dtype=torch.long), 8)
    before = fused_decode_stack.launches
    out = tfd.fused_generate(qm, torch.zeros((1, 4), dtype=torch.long), 3)
    assert out.shape == (1, 3) and fused_decode_stack.launches == before


def test_fused_generate_after_an_in_place_reload_uses_the_new_weights():
    """The stacked weights are cached on the model; a weight load into the
    same model (``load_jax_params`` of another int8 tree) must not leave
    ``fused_generate`` on the old stacks."""
    jm = JGPT2(**SMALL, policy=jdt.FP32)
    trees = [jax.tree.map(np.asarray, jquant(
        jm.init(jax.random.PRNGKey(s), (1, 8))["params"])) for s in (0, 1)]
    prompt = torch.from_numpy(
        np.random.RandomState(4).randint(0, 512, (2, 8)))

    def fresh(tree):
        return GPT2(**SMALL, policy=tdt.FP32, device="cpu",
                    seed=None).load_jax_params(tree)

    model = fresh(trees[0])
    first = tfd.fused_generate(model, prompt, 5)    # stacks of tree A
    model.load_jax_params(trees[1])
    got = tfd.fused_generate(model, prompt, 5)
    want = tfd.fused_generate(fresh(trees[1]), prompt, 5)
    assert torch.equal(got, want) and not torch.equal(first, want)
