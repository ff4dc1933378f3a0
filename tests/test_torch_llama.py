"""Port parity: the Llama family (RoPE, RMSNorm, SwiGLU, GQA) against the
JAX package on the same numpy-seeded inputs and weights.

``apply_rope`` with a scalar offset, per-row offsets and positions up to
32,767: under f32 within 1e-6 of the largest input (the two frameworks'
cos and sin of one f32 angle differ by at most one f32 ulp); under bf16
within one bf16 ulp of each output (2**-8 of its magnitude: the f32 values
before the cast may straddle a rounding point), plus 1e-6 of the largest
input. ``RMSNorm``, ``LlamaBlock`` and a tiny ``Llama`` (tied and untied
heads, MHA and GQA, through the flash backend) under FP32: 1e-5 of the
largest output; the weights come through ``load_jax_params`` and
``jax_param_tree`` returns them bit for bit. Greedy ``generate`` is
token-exact on a seed whose emitted tokens lead the runner-up by more
than 1e-3.

Three AdamW steps of the tiny flash Llama against the JAX trainer under
FP32, once with the backward forced onto the split kernels on both sides
(``TNN_FLASH_FUSED_BWD=0``) and once on the fused one: per-step loss
within 1e-5 relative, every parameter within 1e-5 of its tensor's largest
value. Under bf16 the port runs against the JAX trainer under MIXED_BF16:
readings of the per-step loss, the update's relative L2 distance and the
smallest per-tensor update cosine, for the port in bf16 and in FP32
(``python -m tests.test_torch_llama`` with the suite's XLA flag prints
them):

    backward   port bf16                   port FP32
    split      1.31e-5  0.02313  0.99881   7.9e-5  0.02941  0.99784
    fused      1.31e-5  0.02313  0.99881   7.9e-5  0.02941  0.99784

(the port's plain backward is one function for both paths, and JAX's two
kernels agree here). The bounds, 3e-5, 0.027 and 0.998, hold the bf16
port, and the port in FP32 falls outside each of them; the margins of the
update readings are small, because Adam scales rounding noise in
near-zero gradients to +-lr (as for GPT-2, ``tests/test_torch_training.
py``), so the loss bound is the one that tells bf16 from FP32 math.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu import nn as jnn
from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models.gpt2 import generate as jgenerate
from tnn_tpu.models.llama import Llama as JLlama
from tnn_tpu.models.llama import LlamaBlock as JLlamaBlock
from tnn_tpu.nn.attention import apply_rope as japply_rope
from tnn_tpu.nn.norms import RMSNorm as JRMSNorm
from tnn_tpu.train import create_train_state as jcreate
from tnn_tpu.train import make_train_step as jmake_step
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models import zoo
from tnn_tpu_torch.models.gpt2 import generate
from tnn_tpu_torch.models.llama import Llama, LlamaBlock
from tnn_tpu_torch.nn import optimizers, schedulers
from tnn_tpu_torch.nn.attention import apply_rope
from tnn_tpu_torch.nn.norms import RMSNorm
from tnn_tpu_torch.ops import flash_attention as fa
from tnn_tpu_torch.train import create_train_state, make_train_step

REL = 1e-5
TINY = dict(vocab_size=257, max_len=32, num_layers=2, d_model=64,
            num_heads=4, backend="pallas")


def _close(got, ref, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 37, "rows", 32740])
def test_apply_rope_matches_jax(dtype, offset):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 27, 16)).astype(np.float32)
    off = np.array([5, 32740], np.int32) if offset == "rows" else offset
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = np.asarray(japply_rope(jx, jnp.asarray(off) if offset == "rows"
                                 else off, 500000.0).astype(jnp.float32))
    got = apply_rope(tx, torch.from_numpy(off) if offset == "rows" else off,
                     500000.0)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    err = np.abs(got.float().numpy() - ref)
    limit = 1e-6 * np.abs(x).max()
    if dtype == "bfloat16":
        limit = limit + 2 ** -8 * np.abs(ref)
    assert (err <= limit).all(), err.max()
    with pytest.raises(ValueError, match="even head dim"):
        apply_rope(torch.zeros(1, 1, 4, 7))


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.normal(size=48)).astype(np.float32)
    ref = JRMSNorm(policy=jdt.FP32).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))[0]
    norm = RMSNorm(48, policy=tdt.FP32, device="cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
    _close(norm(torch.from_numpy(x)), ref)
    # bf16 in, bf16 out; the statistics in f32
    assert norm(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_llama_block_matches_jax(kv_heads):
    jb = JLlamaBlock(4, 96, num_kv_heads=kv_heads, backend="pallas",
                     policy=jdt.FP32)
    params = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(4),
                                              (2, 12, 64))["params"])
    tb = LlamaBlock(64, 4, 96, num_kv_heads=kv_heads, backend="pallas",
                    policy=tdt.FP32, device="cpu")
    with torch.no_grad():
        for ln in ("ln1", "ln2"):
            getattr(tb, ln).scale.copy_(torch.tensor(params[ln]["scale"]))
        for name in ("qkv_kernel", "out_kernel"):
            getattr(tb.attn, name).copy_(torch.tensor(
                params["attn"][name]))
        for dense in ("gate", "up", "down"):
            getattr(tb, dense).kernel.copy_(torch.tensor(
                params[dense]["kernel"]))
    assert tb.attn.qkv_bias is None and tb.attn.out_bias is None
    x = np.random.default_rng(5).normal(size=(2, 12, 64)).astype(np.float32)
    ref = jb.apply({"params": params}, jnp.asarray(x))[0]
    _close(tb(torch.from_numpy(x)), ref)


def _pair(kv_heads=None, tie=True, policy=tdt.FP32, seed=0, **kw):
    """The JAX Llama in FP32 and the port under ``policy``, same weights."""
    cfg = dict(TINY, num_kv_heads=kv_heads, tie_embeddings=tie, **kw)
    jm = JLlama(**cfg, policy=jdt.FP32)
    params = jm.init(jax.random.PRNGKey(seed), (1, 8))["params"]
    tm = Llama(**cfg, policy=policy, device="cpu", seed=None)
    tm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, tm


def _leaves(tree, prefix=()):
    for key, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(v)


@pytest.mark.parametrize("kv_heads,tie", [(None, True), (2, False)],
                         ids=["mha_tied", "gqa_untied"])
def test_llama_logits_and_weight_tree_match_jax(kv_heads, tie):
    jm, params, tm = _pair(kv_heads, tie)
    ids = np.random.default_rng(6).integers(0, 257, (2, 12)).astype(np.int32)
    ref = jm.apply({"params": params}, jnp.asarray(ids))[0]
    out = tm(torch.from_numpy(ids).long())
    assert out.dtype == torch.float32 and out.shape == (2, 12, 257)
    _close(out, ref)
    mine = dict(_leaves(tm.jax_param_tree()))
    theirs = dict(_leaves(params))
    assert mine.keys() == theirs.keys()
    for path, value in theirs.items():
        np.testing.assert_array_equal(mine[path], value, err_msg=str(path))
    with pytest.raises(ValueError, match="shape"):
        tm.load_jax_params({**params, "wte": {"table": np.zeros((3, 3))}})


def test_generate_greedy_matches_jax():
    jm, params, tm = _pair(kv_heads=2, seed=3)
    prompt = np.random.default_rng(1).integers(0, 257, (2, 9)).astype(
        np.int32)
    ref = np.asarray(jgenerate(jm, params, jnp.asarray(prompt), 10,
                               max_len=24))
    got = generate(tm, torch.from_numpy(prompt), 10, max_len=24)
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, 10)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the seed is tie-free: each emitted token leads its runner-up
    with torch.no_grad():
        logits = tm(torch.cat([torch.from_numpy(prompt).long(), got], 1))
    top2 = logits[:, 8:-1].topk(2, dim=-1).values
    assert (top2[..., 0] - top2[..., 1]).min() > 1e-3


def test_zoo_llama_geometry():
    m = zoo.create("flash_llama_small", device="meta", seed=None)
    assert (m.num_layers, m.d_model, m.num_heads, m.num_kv_heads,
            m.mlp_hidden, m.vocab_size, m.backend) == \
        (12, 768, 12, 4, 2048, 32000, "pallas")
    assert tuple(m.blocks[0].attn.qkv_kernel.shape) == (768, 768 + 2 * 256)
    assert m.blocks[0].attn.rope_theta == 10000.0
    assert m.blocks[0].ln1.eps == 1e-6 and m.head is None
    big = zoo.create("llama_1b", device="meta", seed=None)
    assert (big.num_layers, big.d_model, big.num_heads,
            big.num_kv_heads) == (16, 2048, 32, 8)


def _train_pair(policy, jpolicy, steps=3, lr=1e-3):
    """The JAX trainer under ``jpolicy`` and the port's trainer under
    ``policy`` from the same weights and batches: (losses, trees, start)."""
    cfg = dict(TINY, num_kv_heads=2)
    jm = JLlama(**cfg, policy=jpolicy)
    jo = jnn.AdamW(lr=lr, weight_decay=0.01, grad_clip_norm=1.0)
    jstate = jcreate(jm, jo, jax.random.PRNGKey(0), (4, 32))
    start = jax.tree.map(np.asarray, jstate.params)
    jstep = jmake_step(jm, jo, scheduler=jnn.WarmupCosineAnnealing(
        warmup=2, t_max=steps), donate=False)
    tm = Llama(**cfg, policy=policy, device="cpu", seed=None)
    tm.load_jax_params(start)
    to = optimizers.AdamW(lr=lr, weight_decay=0.01, grad_clip_norm=1.0)
    tstate = create_train_state(tm, to)
    tstep = make_train_step(tm, to, scheduler=schedulers.WarmupCosineAnnealing(
        warmup=2, t_max=steps))
    rng = np.random.default_rng(5)
    jloss, tloss = [], []
    for _ in range(steps):
        data = rng.integers(0, 257, (4, 33)).astype(np.int32)
        x, y = data[:, :-1], data[:, 1:]
        jstate, jm_ = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tstate, tm_ = tstep(tstate, torch.from_numpy(x).long(),
                            torch.from_numpy(y).long())
        jloss.append(float(jm_["loss"]))
        tloss.append(float(tm_["loss"]))
    assert tstate.step == steps
    return (jloss, tloss, dict(_leaves(jax.tree.map(np.asarray,
                                                    jstate.params))),
            dict(_leaves(tm.jax_param_tree())), dict(_leaves(start)))


@pytest.mark.parametrize("split", [True, False], ids=["split", "fused"])
def test_tiny_flash_llama_train_steps_match_jax_fp32(monkeypatch, split):
    monkeypatch.setenv("TNN_FLASH_FUSED_BWD", "0" if split else "1")
    calls = {}
    for name in ("flash_attention_bwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        real = getattr(fa, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(fa, name, spy)
    jloss, tloss, jtree, ttree, start = _train_pair(tdt.FP32, jdt.FP32)
    want = ({"flash_attention_bwd_dq": 6, "flash_attention_bwd_dkv": 6}
            if split else {"flash_attention_bwd": 6})   # 2 layers x 3 steps
    assert calls == want
    np.testing.assert_allclose(tloss, jloss, rtol=REL, atol=0)
    for path, ref in jtree.items():
        got = ttree[path]
        err = np.abs(got - ref).max()
        assert err <= REL * np.abs(ref).max(), (path, err)
        moved = np.abs(ref - start[path]).max()
        assert moved > 10 * err, path          # the steps did update it


def _bf16_train_readings(policy):
    """Three AdamW steps of the port under ``policy`` against the JAX
    trainer under MIXED_BF16: (largest per-step loss error, relative L2
    distance of the updates, smallest per-tensor update cosine)."""
    jloss, tloss, jtree, ttree, start = _train_pair(policy, jdt.MIXED_BF16)
    loss = max(abs(a - r) / abs(r) for a, r in zip(tloss, jloss))

    def vec(tree):
        return np.concatenate([(tree[p] - start[p]).ravel().astype(np.float64)
                               for p in sorted(tree)])

    upd = np.linalg.norm(vec(ttree) - vec(jtree)) / np.linalg.norm(vec(jtree))
    cos = 1.0
    for path in jtree:
        dj = (jtree[path] - start[path]).ravel().astype(np.float64)
        dt = (ttree[path] - start[path]).ravel().astype(np.float64)
        cos = min(cos, float(dj @ dt / max(
            np.linalg.norm(dj) * np.linalg.norm(dt), 1e-30)))
    return loss, upd, cos


@pytest.mark.parametrize("split", [True, False], ids=["split", "fused"])
def test_tiny_flash_llama_train_steps_bf16_bound(monkeypatch, split):
    monkeypatch.setenv("TNN_FLASH_FUSED_BWD", "0" if split else "1")
    loss, upd, cos = _bf16_train_readings(tdt.MIXED_BF16)
    assert loss <= 3e-5 and upd <= 0.027 and cos > 0.998, (loss, upd, cos)


if __name__ == "__main__":
    # the bf16 readings the module docstring quotes
    import os

    for switch, name in (("0", "split"), ("1", "fused")):
        os.environ["TNN_FLASH_FUSED_BWD"] = switch
        print(name, "port bf16 %.3g %.4g %.5g" % _bf16_train_readings(
            tdt.MIXED_BF16), " port FP32 %.3g %.4g %.5g"
            % _bf16_train_readings(tdt.FP32))
