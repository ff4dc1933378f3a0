"""Port parity: the image models (``tnn_tpu_torch.models.resnet``,
``models.vit``, the vision zoo), their train step, and their files.

Each model is built by both packages at a small size under FP32; the
port's gets the JAX model's parameters and state (``load_jax_params``,
``load_jax_state``). Logits agree to ``MODEL_TOL`` of their magnitude
(1e-5 per layer, compounded over up to 50 conv / norm layers), BatchNorm's
new running statistics after a training forward likewise, and one SGD
step's loss, parameters and state to ``STEP_TOL``. The ViT runs on both
attention backends: "pallas" is the JAX flash kernel in interpret mode
and the port's plain versions of K4 / K7 on the CPU.

``grad_accum=2`` and remat "full" each update BatchNorm's statistics
once per microbatch, as the JAX step's ``lax.scan`` threads them. Files
go both ways: ``.tnn`` model files and ``Checkpoint`` directories written
by either package are read by the other (the JAX package restores the
port's sections by ``load_tensors``: its ``Checkpoint.restore`` wants a
PRNG key where the port stores its generator's state).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu import checkpoint as jckpt
from tnn_tpu import nn as jnn
from tnn_tpu.core import dtypes as jdt
from tnn_tpu.models import resnet as jresnet
from tnn_tpu.models import vit as jvit
from tnn_tpu.models import zoo as jzoo
from tnn_tpu.train import step as jstep
from tnn_tpu_torch import checkpoint as tckpt
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.core.module import module_from_config
from tnn_tpu_torch.models import resnet as tresnet
from tnn_tpu_torch.models import vit as tvit
from tnn_tpu_torch.models import zoo as tzoo
from tnn_tpu_torch.nn.optimizers import SGD
from tnn_tpu_torch.train import step as tstep

MODEL_TOL = 1e-4
STEP_TOL = 1e-4


def _vit(mod, backend, policy, **sizing):
    """The small ViT; the port's is sized by ``init(**sizing)``."""
    model = mod.ViT(num_classes=10, patch_size=8, d_model=64, num_layers=2,
                    num_heads=4, backend=backend, policy=policy)
    if sizing:
        model.init(sizing.pop("input_shape"), **sizing)
    return model


# name: (builder(module, **kw), per-sample input shape, whether a training
# forward is compared). Not compared: the models with dropout (the two
# frameworks draw other masks) and ResNet-50 at 32 x 32, whose last stage
# normalizes each channel over 4 values at 1 x 1, where the statistics'
# rounding (single-pass variance, either package) grows to 1e-2 of the
# logits; its eval forward is compared.
MODELS = {
    "wrn10_1": (lambda m, **kw: m.wrn(depth=10, widen=1, num_classes=10,
                                      **kw), (16, 16, 3), True),
    "resnet18": (lambda m, **kw: m.resnet18(num_classes=10, **kw),
                 (16, 16, 3), True),
    "resnet9": (lambda m, **kw: m.resnet9(num_classes=10, **kw),
                (32, 32, 3), True),
    # the 7x7 / 2 stem and the SAME 3 x 3 / 2 max pool, both asymmetric
    "resnet50_stem": (lambda m, **kw: m.resnet50(num_classes=10,
                                                 small_input=False, **kw),
                      (32, 32, 3), False),
    "mnist_cnn": (lambda m, **kw: m.mnist_cnn(**kw), (28, 28, 1), False),
    "vgg11": (lambda m, **kw: m.vgg11(**kw), (32, 32, 3), False),
    "vit_xla": (lambda m, **kw: _vit(m, "xla", **kw), (16, 16, 3), True),
    "vit_pallas": (lambda m, **kw: _vit(m, "pallas", **kw), (16, 16, 3),
                   True),
}


def _module(name):
    return (jvit, tvit) if name.startswith("vit") else (jresnet, tresnet)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_model(name, batch=4):
    build, shape, _ = MODELS[name]
    model = build(_module(name)[0], policy=jdt.FP32)
    v = model.init(jax.random.PRNGKey(1), (batch,) + shape)
    if v["state"]:     # running statistics away from their init values
        v["state"] = jax.tree.map(
            lambda a: a + 0.1 * jnp.abs(jnp.sin(jnp.arange(a.size))),
            v["state"])
    return model, v


def _port_model(name):
    """The port's model with the JAX model's parameters and state."""
    build, shape, _ = MODELS[name]
    jm, v = _jax_model(name)
    kw = dict(policy=tdt.FP32, input_shape=shape, device="cpu", seed=None)
    model = build(_module(name)[1], **kw)
    model.load_jax_params(_tree_np(v["params"]))
    model.load_jax_state(_tree_np(v["state"]))
    return model


def _images(name, seed=0, batch=4):
    shape = MODELS[name][1]
    return np.random.default_rng(seed).random((batch,) + shape,
                                              dtype=np.float32)


def _close(got, ref, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(1.0, np.abs(ref).max()))


def _trees_close(got, ref, tol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_r = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_r]
    for (_, g), (_, r) in zip(flat_g, flat_r):
        _close(np.asarray(g), r, tol)


def test_zoo_has_every_vision_name():
    # a leading underscore marks an entry a JAX test registered into its
    # zoo in this process (tests/test_examples.py's "_test_tiny_gpt")
    jax_vision = {n for n in jzoo.names() if not n.startswith("_")
                  and not any(k in n for k in ("gpt2", "llama"))}
    assert len(jax_vision) == 12
    assert jax_vision == set(tzoo.vision_names())
    assert jax_vision <= set(tzoo.names())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_state_and_config(name):
    """Eval logits; a training forward's logits and new running
    statistics (where ``MODELS`` compares them); the config and parameter tree
    are the JAX model's, and ``module_from_config`` rebuilds the model
    from that config."""
    jm, v = _jax_model(name)
    model = _port_model(name)
    x = _images(name)
    ref, _ = jm.apply(v, jnp.asarray(x), train=False)
    _close(model(torch.from_numpy(x)), ref, MODEL_TOL)
    if MODELS[name][2]:
        ref, new_state = jm.apply(v, jnp.asarray(x), train=True)
        _close(model(torch.from_numpy(x), train=True), ref, MODEL_TOL)
        model.commit_state()
        _trees_close(model.jax_state_tree(), _tree_np(new_state), MODEL_TOL)
    cfg = jm.get_config()
    assert model.get_config() == cfg
    rebuilt = module_from_config(cfg, device="cpu",
                                 input_shape=MODELS[name][1])
    assert rebuilt.get_config() == cfg
    shapes = jax.tree.map(np.shape, v["params"])
    assert jax.tree.map(np.shape, rebuilt.jax_param_tree()) == shapes
    assert jax.tree.map(np.shape, model.jax_state_tree()) == \
        jax.tree.map(np.shape, _tree_np(v["state"]))


def _jax_step(name, x, y, **kw):
    jm, v = _jax_model(name)
    opt = jnn.SGD(lr=0.1, momentum=0.9)
    state = jstep.TrainState(params=v["params"],
                             opt_state=opt.init(v["params"]),
                             net_state=v["state"],
                             step=jnp.zeros((), jnp.int32),
                             rng=jax.random.PRNGKey(0))
    step = jstep.make_train_step(jm, opt, donate=False, **kw)
    return step(state, jnp.asarray(x), jnp.asarray(y))


def _port_step(name, x, y, **kw):
    model = _port_model(name)
    opt = SGD(lr=0.1, momentum=0.9)
    state = tstep.create_train_state(model, opt)
    step = tstep.make_train_step(model, opt, **kw)
    state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
    return model, state, m


@pytest.mark.parametrize("name", ["wrn10_1", "vit_pallas"])
def test_one_sgd_step(name):
    x, y = _images(name, seed=3), np.arange(4, dtype=np.int64) % 10
    jstate, jm = _jax_step(name, x, y)
    model, state, m = _port_step(name, x, y)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=STEP_TOL)
    _trees_close(model.jax_param_tree(), _tree_np(jstate.params), STEP_TOL)
    _trees_close(model.jax_state_tree(), _tree_np(jstate.net_state),
                 STEP_TOL)
    trees = tstep.train_state_trees(state)
    assert ("net_state" in trees) == bool(jstate.net_state)
    if jstate.net_state:
        _trees_close(trees["net_state"], _tree_np(jstate.net_state),
                     STEP_TOL)


@pytest.mark.parametrize("kw", [dict(grad_accum=2), dict(remat="full"),
                                dict(grad_accum=2, remat="full")],
                         ids=["grad_accum2", "remat_full", "both"])
def test_batchnorm_state_once_per_microbatch(kw):
    """The JAX step threads net_state through its microbatches; the port
    commits once per microbatch, and a remat recompute does not update it
    again: state, loss and parameters agree with the JAX step's."""
    name = "wrn10_1"
    x, y = _images(name, seed=4), np.arange(4, dtype=np.int64) % 10
    jkw = dict(kw)
    if jkw.get("remat") == "full":
        jkw["remat"] = True
    jstate, jm = _jax_step(name, x, y, **jkw)
    model, state, m = _port_step(name, x, y, **kw)
    _trees_close(model.jax_state_tree(), _tree_np(jstate.net_state),
                 STEP_TOL)
    _trees_close(model.jax_param_tree(), _tree_np(jstate.params), STEP_TOL)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=STEP_TOL)
    # one update per microbatch: not the state of a single full-batch update
    one, _ = _jax_step(name, x, y)
    gap = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
              for a, b in zip(jax.tree.leaves(one.net_state),
                              jax.tree.leaves(jstate.net_state)))
    assert (gap > 1e-3) == (kw.get("grad_accum", 1) == 2)


@pytest.mark.parametrize("name", ["wrn10_1", "vit_xla"])
def test_tnn_files_both_ways(tmp_path, name):
    jm, v = _jax_model(name)
    shape = MODELS[name][1]
    x = _images(name, seed=5)
    ref, _ = jm.apply(v, jnp.asarray(x))
    jpath = str(tmp_path / "jax.tnn")
    jckpt.save_model(jpath, jm, v["params"], v["state"])
    model = tckpt.load_model(jpath, device="cpu", input_shape=shape)
    _close(model(torch.from_numpy(x)), ref, MODEL_TOL)
    tpath = str(tmp_path / "port.tnn")
    tckpt.save_model(tpath, model)
    jm2, v2 = jckpt.load_model(tpath, input_shape=(2,) + shape)
    assert jm2.get_config() == jm.get_config()
    _trees_close(_tree_np(v2["params"]), _tree_np(v["params"]), 0.0)
    _trees_close(_tree_np(v2["state"]), _tree_np(v["state"]), 0.0)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()


def test_checkpoint_both_ways(tmp_path):
    """A JAX ``Checkpoint`` restores into the port's state (params,
    momentum, BatchNorm state, step); the port's sections load into the
    JAX package's trees."""
    name = "wrn10_1"
    x, y = _images(name, seed=6), np.arange(4, dtype=np.int64) % 10
    jstate, _ = _jax_step(name, x, y)
    jdir = str(tmp_path / "jax")
    jckpt.Checkpoint(jdir).save(jstate)
    model = _port_model(name)
    opt = SGD(lr=0.1, momentum=0.9)
    state = tstep.create_train_state(model, opt)
    state, meta = tckpt.Checkpoint(jdir).restore(state)
    assert state.step == 1 and meta["step"] == 1
    trees = tstep.train_state_trees(state)
    _trees_close(trees["params"], _tree_np(jstate.params), 0.0)
    _trees_close(trees["net_state"], _tree_np(jstate.net_state), 0.0)
    _trees_close(trees["opt_state"], _tree_np(jstate.opt_state), 0.0)
    tdir = tckpt.Checkpoint(str(tmp_path / "port")).save(state, model=model)
    loaded, tmeta = jckpt.load_tensors(tdir + "/state.tnn", {
        "params": jstate.params, "opt_state": jstate.opt_state,
        "net_state": jstate.net_state, "step": jstate.step})
    assert int(loaded["step"]) == 1
    assert tmeta["model_config"] == _jax_model(name)[0].get_config()
    for key in ("params", "opt_state", "net_state"):
        _trees_close(_tree_np(loaded[key]),
                     _tree_np(getattr(jstate, key)), 0.0)


@torch.no_grad()
def test_seeded_init_families():
    """Seeded weights: he-normal conv kernels (fan-in kh * kw * cin), zero
    biases and class token, unit norm scales, BatchNorm state at (0, 1)."""
    model = tresnet.wrn(depth=10, widen=1, num_classes=10, policy=tdt.FP32,
                        input_shape=(16, 16, 3), device="cpu", seed=3)
    stem = model.layers[0].kernel.clone()
    assert abs(float(stem.std()) - (2.0 / 27) ** 0.5) < 0.05
    tree = model.jax_state_tree()
    assert all((leaf["mean"] == 0).all() and (leaf["var"] == 1).all()
               for leaf in _bn_leaves(tree))
    vit = tvit.ViT(num_classes=10, patch_size=8, d_model=64, num_layers=1,
                   num_heads=4).init((16, 16, 3), device="cpu", seed=3)
    assert float(vit.cls.token.abs().max()) == 0.0
    assert float(vit.blocks[0].ln1.scale.min()) == 1.0
    assert abs(float(vit.pos.pos.std()) - 0.02) < 0.005
    again = tresnet.wrn(depth=10, widen=1, num_classes=10, policy=tdt.FP32,
                        input_shape=(16, 16, 3), device="cpu", seed=3)
    assert torch.equal(again.layers[0].kernel, stem)


def _bn_leaves(tree):
    if "mean" in tree:
        yield tree
        return
    for sub in tree.values():
        yield from _bn_leaves(sub)
