"""Port parity: the training path (losses, metrics, optimizers, schedulers,
the token-stream loader and the train step) against the JAX package on the
same numpy-seeded inputs.

Tolerances. Losses and metrics: 1e-6 relative (float32, the same terms in
another order). Optimizers and schedulers: 1e-6 relative over five updates
(the same float32 terms in the same order, as the port's docstring says).
The tiny flash GPT-2 under FP32: per-step loss and every parameter after
three AdamW steps within 1e-5 relative to the largest value of its tensor.

Under bf16 the port runs against the JAX model under MIXED_BF16 on the
same weights and batches. The bounds were set from two readings each: the
port's, and that of the JAX model run in FP32, which is what a port that
skipped the bf16 roundings would read (the port in FP32 reads about the
same).
One forward and backward, relative to the JAX bf16 values:

    quantity                     port     bound    JAX FP32
    loss                         4.73e-6  8e-6     1.19e-5
    logits, relative L2          1.79e-3  4e-3     9.73e-3
    gradients, relative L2       6.40e-3  9e-3     1.34e-2
    the same, f32 output grad    4.22e-3  6e-3     1.34e-2

The forward differs only where XLA's and PyTorch's GELU round differently
in float32 and so flip a bf16 rounding. The last row swaps the port's
matmul backward for JAX's transposition, which keeps the f32 output
gradient instead of rounding it to bf16 first: that rounding accounts for
the difference between the last two rows. Over three
AdamW steps the per-step loss reads 2.17e-5 (bound 4e-5), the update's
relative L2 distance 0.0220 (bound 0.04) and the smallest per-tensor
cosine 0.99951 (bound 0.999); these do not tell bf16 from FP32 (the port
in FP32 reads 3.72e-5, 0.0217 and 0.99954), because Adam scales the
rounding noise of gradients near zero up to +-lr. The key bias is left out
of every gradient and update check: adding a constant to every key of a
row leaves its softmax unchanged, so its gradient is zero but for
rounding. With the suite's XLA flag,
``XLA_FLAGS=--xla_backend_optimization_level=0 python -m
tests.test_torch_training`` prints these readings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu import nn as jnn
from tnn_tpu.core import dtypes as jdt
from tnn_tpu.data.token_stream import TokenStreamDataLoader as JLoader
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.nn import losses as jlosses
from tnn_tpu.nn import metrics as jmetrics
from tnn_tpu.nn import optimizers as jopt
from tnn_tpu.nn import schedulers as jsched
from tnn_tpu.train import create_train_state as jcreate
from tnn_tpu.train import make_train_step as jmake_step
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.data.token_stream import TokenStreamDataLoader
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.nn import layers, losses, metrics, optimizers, schedulers
from tnn_tpu_torch.train import (create_train_state, make_eval_step,
                                 make_train_step)

REL = 1e-6


def _rel_close(a, ref, rel):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert np.abs(a - ref).max() <= rel * max(np.abs(ref).max(), 1e-30)


def _logits_labels(seed, ignore=True):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(3, 7, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    if ignore:
        labels[0, :3] = -1
    labels[1, 2] = int(np.argmax(logits[1, 2]))
    return logits, labels


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("ignore", [True, False])
def test_softmax_cross_entropy(smoothing, ignore):
    logits, labels = _logits_labels(0, ignore)
    ref = jlosses.softmax_cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(labels),
                                        label_smoothing=smoothing)
    fn = losses.get({"type": "softmax_cross_entropy",
                     "label_smoothing": smoothing})
    _rel_close(fn(torch.tensor(logits), torch.tensor(labels)), ref, REL)


def test_softmax_cross_entropy_soft_targets_and_registry():
    logits, labels = _logits_labels(1, ignore=False)
    onehot = np.eye(11, dtype=np.float32)[labels] * 0.8 + 0.2 / 11
    ref = jlosses.softmax_cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(onehot))
    got = losses.softmax_cross_entropy(torch.tensor(logits),
                                       torch.tensor(onehot))
    _rel_close(got, ref, REL)
    with pytest.raises(KeyError, match="unknown loss"):
        losses.get("mse")


@pytest.mark.parametrize("ignore", [True, False])
def test_accuracy_and_class_corrects(ignore):
    logits, labels = _logits_labels(2, ignore)
    t, tl = torch.tensor(logits), torch.tensor(labels)
    _rel_close(metrics.accuracy(t, tl),
               jmetrics.accuracy(jnp.asarray(logits), jnp.asarray(labels)),
               REL)
    assert int(metrics.class_corrects(t, tl)) == int(jmetrics.class_corrects(
        jnp.asarray(logits), jnp.asarray(labels)))
    onehot = np.eye(11, dtype=np.float32)[np.maximum(labels, 0)]
    _rel_close(metrics.accuracy(t, torch.tensor(onehot)),
               jmetrics.accuracy(jnp.asarray(logits), jnp.asarray(onehot)),
               REL)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"dense": {"kernel": rng.normal(size=(6, 5)).astype(np.float32),
                      "bias": rng.normal(size=(5,)).astype(np.float32)},
            "ln": {"scale": (1 + rng.normal(size=(5,)) * 0.1
                             ).astype(np.float32)}}


OPTIMIZERS = {
    "adamw_clip": lambda m: m.AdamW(lr=3e-2, weight_decay=0.01,
                                    grad_clip_norm=1.0),
    "adam_l2_amsgrad": lambda m: m.Adam(lr=1e-2, weight_decay=0.05,
                                        amsgrad=True),
    "sgd_nesterov": lambda m: m.SGD(lr=0.1, momentum=0.9, nesterov=True,
                                    weight_decay=0.01, grad_clip_norm=0.5),
    "sgd_plain": lambda m: m.SGD(lr=0.1),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_with_warmup_cosine_matches_jax(name):
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](optimizers)
    js = jsched.WarmupCosineAnnealing(warmup=2, t_max=5)
    ts = schedulers.WarmupCosineAnnealing(warmup=2, t_max=5)
    jparams = jax.tree.map(jnp.asarray, _tree(0))
    tparams = {k: {kk: torch.tensor(vv) for kk, vv in v.items()}
               for k, v in _tree(0).items()}
    jstate, tstate = jo.init(jparams), to.init(tparams)
    for t in range(5):
        grads = _tree(10 + t)
        jparams, jstate = jo.update(jax.tree.map(jnp.asarray, grads), jstate,
                                    jparams, lr_scale=js.scale(t))
        tgrads = optimizers.tree_map(torch.tensor, grads)
        with torch.no_grad():
            tparams, tstate = to.update(tgrads, tstate, tparams,
                                        lr_scale=ts.scale(t))
    for a, r in zip(optimizers.tree_leaves(tparams),
                    jax.tree_util.tree_leaves(jparams)):
        _rel_close(a, r, REL)
    assert int(tstate["step"]) == int(jstate["step"]) == 5


def test_global_norm_and_clip():
    g = _tree(3)
    jg = jax.tree.map(jnp.asarray, g)
    tg = optimizers.tree_map(torch.tensor, g)
    _rel_close(optimizers.global_norm(tg), jopt.global_norm(jg), REL)
    for a, r in zip(optimizers.tree_leaves(
            optimizers.clip_by_global_norm(tg, 0.7)),
            jax.tree_util.tree_leaves(jopt.clip_by_global_norm(jg, 0.7))):
        _rel_close(a, r, REL)


@pytest.mark.parametrize("eta", [0.0, 0.1])
def test_schedulers(eta):
    js = jsched.WarmupCosineAnnealing(warmup=3, t_max=11, eta_min_scale=eta)
    ts = schedulers.WarmupCosineAnnealing(warmup=3, t_max=11,
                                          eta_min_scale=eta)
    for t in range(14):
        _rel_close(ts.scale(t), js.scale(t), REL)
    assert float(schedulers.NoOp().scale(4)) == 1.0


@pytest.mark.parametrize("pad", [None, 7])
def test_token_stream_windows_identical(tmp_path, pad):
    toks = np.random.default_rng(4).integers(0, 300, 5000).astype(np.uint16)
    path = tmp_path / "train.bin"
    toks.tofile(path)
    jl = JLoader(str(path), 33, pad_token_id=pad)
    tl = TokenStreamDataLoader(str(path), 33, pad_token_id=pad)
    assert len(tl) == len(jl) == 5000 - 33
    for seed in (0, 1):
        jd, jlab = jl.random_windows(6, np.random.default_rng(seed))
        td, tlab = tl.random_windows(6, np.random.default_rng(seed))
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tlab, jlab)
        assert td.dtype == np.int32 and tlab.dtype == np.int32
    # the loader's own seeded generator draws the same windows too
    np.testing.assert_array_equal(tl.random_windows(3)[0],
                                  jl.random_windows(3)[0])
    short = tmp_path / "short.bin"
    toks[:20].tofile(short)
    with pytest.raises(ValueError, match="too short"):
        TokenStreamDataLoader(str(short), 33).random_windows(1)


TINY = dict(vocab_size=257, max_len=32, num_layers=2, d_model=64,
            num_heads=2, backend="pallas")


def _start(params):
    """The JAX model's initial parameters with non-zero biases, so each
    tensor's values set the scale of its bound."""
    rng = np.random.default_rng(9)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + (rng.normal(size=x.shape) * 0.05)
        .astype(np.float32) if "bias" in str(path[-1]) else np.asarray(x),
        params)


def _train_pair(policy, jpolicy, steps=3, lr=1e-3):
    """The JAX trainer under ``jpolicy`` and the port's trainer under
    ``policy`` from the same weights and batches; returns losses, trees
    and the start."""
    jm = JGPT2(**TINY, dropout=0.0, policy=jpolicy)
    jo = jnn.AdamW(lr=lr, weight_decay=0.01, grad_clip_norm=1.0)
    js = jnn.WarmupCosineAnnealing(warmup=2, t_max=steps)
    jstate = jcreate(jm, jo, jax.random.PRNGKey(0), (4, 32))
    start = _start(jstate.params)
    jstate = jstate._replace(params=jax.tree.map(jnp.asarray, start))
    jstep = jmake_step(jm, jo, scheduler=js, donate=False)
    tm = GPT2(**TINY, policy=policy, device="cpu", seed=None)
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
        assert abs(float(tm_["accuracy"]) - float(jm_["accuracy"])) <= 0.05
    jtree = jax.tree.map(np.asarray, jstate.params)
    assert tstate.step == steps
    return jloss, tloss, jtree, tm.jax_param_tree(), start, tm


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    if path[-1] == "qkv_bias":    # without the key bias (module docstring)
        d = TINY["d_model"]
        return np.concatenate([tree[:d], tree[2 * d:]])
    return tree


def _vec(tree):
    """Every parameter (the key bias left out) in one float64 vector, in
    the order of the sorted paths."""
    return np.concatenate([np.asarray(_at(tree, p), np.float64).ravel()
                           for p in sorted(p for p, _ in _paths(tree))])


def _rel_l2(a, ref):
    return np.linalg.norm(a - ref) / np.linalg.norm(ref)


def test_tiny_flash_gpt2_train_steps_match_jax_fp32():
    jloss, tloss, jtree, ttree, start, tm = _train_pair(tdt.FP32, jdt.FP32)
    _rel_close(tloss, jloss, 1e-5)
    for path, _ in _paths(jtree):
        ref, got = _at(jtree, path), _at(ttree, path)
        assert got.shape == ref.shape, path
        err = np.abs(got - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (path, err)
        moved = np.abs(ref - _at(start, path)).max()
        assert moved > 10 * err or moved == 0.0, path   # steps did update


def _bf16_train_readings(policy):
    """Three AdamW steps of the port under ``policy`` against the JAX
    trainer under MIXED_BF16: (largest per-step loss error, relative L2
    distance of the updates, smallest per-tensor update cosine)."""
    jloss, tloss, jtree, ttree, start, tm = _train_pair(policy,
                                                        jdt.MIXED_BF16)
    assert tm.wte.table.dtype == torch.float32    # f32 masters
    loss = max(abs(a - r) / abs(r) for a, r in zip(tloss, jloss))
    upd = _rel_l2(_vec(ttree) - _vec(start), _vec(jtree) - _vec(start))
    cos = 1.0
    for path, _ in _paths(jtree):
        dj = (_at(jtree, path) - _at(start, path)).ravel()
        dt = (_at(ttree, path) - _at(start, path)).ravel()
        cos = min(cos, float(dj @ dt / max(
            np.linalg.norm(dj) * np.linalg.norm(dt), 1e-30)))
    return loss, upd, cos


def test_tiny_flash_gpt2_train_steps_bf16_bound():
    loss, upd, cos = _bf16_train_readings(tdt.MIXED_BF16)
    assert loss <= 4e-5 and upd <= 0.04 and cos > 0.999, (loss, upd, cos)


class _MatmulF32JaxBackward(layers._MatmulF32):
    """JAX's transposition of the f32-output dot: the f32 output gradient
    times the other operand, in f32, rounded once at the end."""

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        return ((g @ w.float().t()).to(x2.dtype),
                (x2.float().t() @ g).to(w.dtype))


def _loss_logits_grads(x, y, start, policy=None, jpolicy=None):
    """One forward and backward of the tiny flash GPT-2 from ``start``:
    (loss, logits, gradient vector), by the port under ``policy`` or by
    the JAX model under ``jpolicy``."""
    if jpolicy is not None:
        jm = JGPT2(**TINY, dropout=0.0, policy=jpolicy)

        def f(params):
            out = jm.apply({"params": params, "state": {}}, jnp.asarray(x))[0]
            return jlosses.softmax_cross_entropy(out, jnp.asarray(y)), out

        (loss, out), g = jax.value_and_grad(f, has_aux=True)(
            jax.tree.map(jnp.asarray, start))
        return (float(loss), np.asarray(out, np.float64),
                _vec(jax.tree.map(np.asarray, g)))
    tm = GPT2(**TINY, policy=policy, device="cpu", seed=None)
    tm.load_jax_params(start)
    out = tm(torch.from_numpy(x).long())
    loss = losses.softmax_cross_entropy(out, torch.from_numpy(y).long())
    loss.backward()
    grads: dict = {}
    for path, param in tm.jax_param_paths():
        node = grads
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = param.grad.numpy()
    return float(loss.detach()), out.detach().double().numpy(), _vec(grads)


@pytest.mark.parametrize("cotangent,grad_bound", [("bf16", 9e-3),
                                                  ("f32", 6e-3)])
def test_tiny_flash_gpt2_bf16_forward_backward_match_jax_bf16(
        monkeypatch, cotangent, grad_bound):
    """One step's loss, logits and gradients against the JAX model under
    MIXED_BF16, with the bounds and readings of the module docstring; the
    JAX model in FP32 must fall outside them. ``cotangent="f32"`` measures
    the port with JAX's matmul transposition in place of its own."""
    if cotangent == "f32":
        monkeypatch.setattr(layers, "_MatmulF32", _MatmulF32JaxBackward)
    port, f32 = _bf16_step_readings()
    bounds = (8e-6, 4e-3, grad_bound)
    assert all(r <= b for r, b in zip(port, bounds)), port
    assert all(r > b for r, b in zip(f32, bounds)), f32


def _bf16_step_readings():
    """(loss error, logits relative L2, gradients relative L2) against the
    JAX model under MIXED_BF16, of the port under MIXED_BF16 and of the
    JAX model in FP32."""
    jm = JGPT2(**TINY, dropout=0.0, policy=jdt.FP32)
    start = _start(jm.init(jax.random.PRNGKey(0), (4, 32))["params"])
    data = np.random.default_rng(5).integers(0, 257, (4, 33)).astype(np.int32)
    x, y = data[:, :-1], data[:, 1:]
    ref = _loss_logits_grads(x, y, start, jpolicy=jdt.MIXED_BF16)

    def readings(got):
        return (abs(got[0] - ref[0]) / abs(ref[0]), _rel_l2(got[1], ref[1]),
                _rel_l2(got[2], ref[2]))

    return (readings(_loss_logits_grads(x, y, start, policy=tdt.MIXED_BF16)),
            readings(_loss_logits_grads(x, y, start, jpolicy=jdt.FP32)))


def test_grad_accum_and_steps_per_call():
    """grad_accum=2 averages two microbatch gradients into the update one
    full-batch step gives (1e-5 relative, float32 sums in another order);
    steps_per_call=2 returns the per-step loss trace and mean metrics."""
    def build(**kw):
        m = GPT2(**TINY, policy=tdt.FP32, device="cpu", seed=1)
        o = optimizers.AdamW(lr=1e-3, weight_decay=0.01, grad_clip_norm=1.0)
        return m, create_train_state(m, o), make_train_step(m, o, **kw)

    rng = np.random.default_rng(6)
    data = torch.from_numpy(rng.integers(0, 257, (4, 33))).long()
    x, y = data[:, :-1], data[:, 1:]
    m1, s1, step1 = build()
    m2, s2, step2 = build(grad_accum=2)
    _, a = step1(s1, x, y)
    _, b = step2(s2, x, y)
    _rel_close(b["loss"], a["loss"], 1e-5)
    for p, q in zip(m1.parameters(), m2.parameters()):
        torch.testing.assert_close(q, p, atol=1e-5, rtol=1e-5)
    m3, s3, step3 = build(steps_per_call=2)
    xs, ys = torch.stack([x, x]), torch.stack([y, y])
    s3, m = step3(s3, xs, ys)
    assert m["loss_trace"].shape == (2,) and s3.step == 2
    _rel_close(m["loss_trace"][0], a["loss"], 1e-6)
    _rel_close(m["loss"], m["loss_trace"].mean(), 1e-6)
    ev = make_eval_step(m3)(s3, x, y)
    assert float(ev["loss"]) < float(m["loss_trace"][0])
    assert 0 <= int(ev["corrects"]) <= x.numel()


@pytest.mark.parametrize("kw", [dict(remat=True), dict(lm_head_chunk=64),
                                dict(augment=lambda d: d)])
def test_unported_step_options_raise(kw):
    m = GPT2(**TINY, device="cpu", seed=None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(m, optimizers.AdamW(), **kw)


def test_dropout_needs_a_generator_and_keeps_scale():
    from tnn_tpu_torch.nn.layers import Dropout

    x = torch.ones(2000)
    d = Dropout(0.25)
    assert d(x) is x and Dropout(0.0)(x, train=True) is x
    with pytest.raises(ValueError, match="generator"):
        d(x, train=True)
    y = d(x, train=True, generator=torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert 0.7 < kept.float().mean() < 0.8


if __name__ == "__main__":
    # the bf16 readings the module docstring quotes
    port, f32 = _bf16_step_readings()
    print("one step (loss, logits, gradients): port %.3g %.3g %.3g, "
          "JAX FP32 %.3g %.3g %.3g" % (*port, *f32))
    layers._MatmulF32 = _MatmulF32JaxBackward
    print("  with the f32 output gradient: port %.3g %.3g %.3g"
          % _bf16_step_readings()[0])
    layers._MatmulF32 = _MatmulF32JaxBackward.__base__
    for name, policy in (("MIXED_BF16", tdt.MIXED_BF16), ("FP32", tdt.FP32)):
        print("three steps, port in %s (loss, update L2, cosine): "
              "%.3g %.4g %.5g" % (name, *_bf16_train_readings(policy)))
