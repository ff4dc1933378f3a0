"""Port parity: ``train_model`` and ``cli.trainer`` over a mesh
(``config.mesh_axes``), against the JAX package's ``train_model`` on its 8
virtual CPU devices; the port's mesh is 8 ``"cpu"`` positions.

- ``{"data": 8}`` (a BatchNorm MLP) and ``{"data": 2, "fsdp": 4}`` (two
  512-wide layers, sharded): each epoch's train and validation loss within
  1e-5 relative of JAX's, the final parameters within rtol 1e-5 / atol
  1e-6.
- ``{"data": 2, "pipe": 4}`` on the conv + BatchNorm net, the port model
  carrying JAX's initial packed rows: the same, with the JAX run's SGD
  learning rate divided by pp x data = 8, because its pipeline step's
  gradient is that many times the loss's on this JAX version (ROADMAP.md
  section 3; ``test_torch_parallel.py`` holds the gradients themselves).
- A ``{"pipe": 4}`` checkpoint resumes in the other package: JAX's
  snapshot restores into the port's pipeline state (the packed params,
  momentum rows, state rows and step equal), and the port's snapshot
  loads into JAX's templates.
- A ``{"data": 2}`` run with dropout 0.1 cut after 2 steps and resumed
  from its snapshot equals the unbroken run bit for bit: the parameters,
  the momentum and the generator (every replica's masks follow from it).
- ``cli.trainer --mesh data=2,pipe=2`` runs with ``--device cpu``.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from tnn_tpu import checkpoint as jckpt
from tnn_tpu import nn as jnn
from tnn_tpu import parallel as jpar
from tnn_tpu.core import dtypes as jdt
from tnn_tpu.data.loader import ArrayDataLoader as JLoader
from tnn_tpu.nn import optimizers as jopt
from tnn_tpu.train import create_train_state as jcreate
from tnn_tpu.train import train_model as jtrain
from tnn_tpu.utils.config import TrainingConfig as JConfig
from tnn_tpu_torch.checkpoint import Checkpoint
from tnn_tpu_torch.core.module import config_module
from tnn_tpu_torch.data.loader import ArrayDataLoader
from tnn_tpu_torch.train import train_model, train_state_trees
from tnn_tpu_torch.utils.config import TrainingConfig

F32 = jdt.FP32
CPU8 = ["cpu"] * 8
BASE = dict(epochs=2, batch_size=16, progress_print_interval=2,
            io_dtype="float32", compute_dtype="float32", seed=0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _data(shape, n=64, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + shape).astype(np.float32)
    x[::2] *= 3.0
    return x, rng.integers(0, classes, n).astype(np.int32)


def _loaders(cls, shape, classes):
    x, y = _data(shape, classes=classes)
    return cls(x[:48], y[:48]), cls(x[48:], y[48:])


def _bn_mlp():
    return jnn.Sequential([jnn.Dense(16, use_bias=False, policy=F32),
                           jnn.BatchNorm(policy=F32),
                           jnn.Activation("relu", policy=F32),
                           jnn.Dense(4, policy=F32)], policy=F32)


def _wide():
    return jnn.Sequential([jnn.Dense(512, activation="relu", policy=F32),
                           jnn.Dense(512, activation="relu", policy=F32),
                           jnn.Dense(4, policy=F32)], policy=F32)


def _conv_bn_net():
    return jnn.Sequential([
        jnn.Conv2D(8, 3, padding="same", use_bias=False, policy=F32),
        jnn.BatchNorm(policy=F32), jnn.Activation("relu", policy=F32),
        jnn.Conv2D(16, 3, strides=2, padding="same", use_bias=False,
                   policy=F32),
        jnn.BatchNorm(policy=F32), jnn.Activation("relu", policy=F32),
        jnn.GlobalAvgPool(policy=F32), jnn.Dense(10, policy=F32),
    ], name="convbn", policy=F32)


def _port_model(jmodel, shape, params, state):
    model = config_module(jmodel.get_config()).init(shape, device="cpu",
                                                    seed=None)
    model.load_jax_params(params)
    if state:
        model.load_jax_state(state)
    return model


def _compare(hist, jhist, model, jparams, rtol=1e-5, atol=1e-6):
    assert len(hist) == len(jhist)
    for got, want in zip(hist, jhist):
        assert got["batches"] == want["batches"]
        for key in ("train_loss", "val_loss"):
            assert got[key] == pytest.approx(want[key], rel=1e-5), key
    for path, p in model.jax_param_paths():
        np.testing.assert_allclose(p.detach().numpy(),
                                   _leaf(jparams, path), rtol=rtol,
                                   atol=atol, err_msg="/".join(path))


@pytest.mark.parametrize("case", ["data8", "data2_fsdp4"])
def test_train_model_data_parallel_matches_jax(case, tmp_path):
    if case == "data8":
        jmodel, shape, axes, classes = _bn_mlp(), (8,), {"data": 8}, 4
    else:
        jmodel, shape, axes, classes = _wide(), (512,), {"data": 2,
                                                         "fsdp": 4}, 4
    cfg = dict(BASE, mesh_axes=axes,
               optimizer={"type": "sgd", "lr": 0.05, "momentum": 0.9})
    jstate = jcreate(jmodel, jopt.from_config(cfg["optimizer"]),
                     jax.random.PRNGKey(0), (16,) + shape)
    model = _port_model(jmodel, shape, _np(jstate.params),
                        _np(jstate.net_state))
    jstate, jhist = jtrain(jmodel, JConfig().update(
        dict(cfg, snapshot_dir=str(tmp_path / "jax"))),
        *_loaders(JLoader, shape, classes), state=jstate)
    state, hist = train_model(model, TrainingConfig().update(
        dict(cfg, snapshot_dir=str(tmp_path / "port"))),
        *_loaders(ArrayDataLoader, shape, classes), devices=CPU8)
    _compare(hist, jhist, model, _np(jstate.params))
    assert state.step == int(jstate.step) == 6
    if case == "data8":
        want = _np(jstate.net_state)
        for path, buf in model.jax_state_paths():
            np.testing.assert_allclose(buf.numpy(), _leaf(want, path),
                                       rtol=1e-5, atol=1e-6)
    else:
        assert len(state.layout.sharded_names()) == 2
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))


def test_dp_resume_with_dropout_equals_unbroken_run(tmp_path):
    jmodel = jnn.Sequential([jnn.Dense(32, activation="relu", policy=F32),
                             jnn.Dropout(0.1, policy=F32),
                             jnn.Dense(4, policy=F32)], policy=F32)

    def run(name, seed, **kw):
        model = config_module(jmodel.get_config()).init(
            (8,), device="cpu", seed=seed)
        cfg = dict(BASE, epochs=1, mesh_axes={"data": 2},
                   snapshot_dir=str(tmp_path / name),
                   optimizer={"type": "sgd", "lr": 0.05, "momentum": 0.9},
                   **kw)
        state, hist = train_model(model, TrainingConfig().update(cfg),
                                  *_loaders(ArrayDataLoader, (8,), 4),
                                  devices=CPU8)
        return state, hist

    full, _ = run("full", 0)
    cut, hist = run("cut", 0, max_steps=2)
    assert hist[0]["batches"] == 2 and cut.step == 2
    resumed, hist = run("resumed", 7,
                        resume=str(tmp_path / "cut" / "step_2"))
    assert hist[0]["batches"] == 1 and resumed.step == full.step == 3
    for a, b in zip(resumed.params.values(), full.params.values()):
        assert torch.equal(a, b)
    for name, v in full.opt_state["velocity"].items():
        assert torch.equal(resumed.opt_state["velocity"][name], v)
    assert torch.equal(resumed.generator.get_state(),
                       full.generator.get_state())


def _global_key(part, local_key):
    j, typ = int(local_key.split("_")[0]), local_key.split("_", 1)[1]
    return f"{part.start + j:02d}_{typ}"


def _jax_pipeline_init(jmodel, pp, dp, mb_global, shape, num_mb, seed=0):
    """The per-layer trees of JAX's ``train_model`` pipeline init (the
    same stages, mesh and key), merged into the unsplit model's layout."""
    parts = jpar.balanced_partitions(jmodel, pp, (mb_global,) + shape)
    stages = jpar.split(jmodel, parts)
    mesh = jpar.make_mesh(data=dp, pipe=pp)
    pipe, _, init_fn = jpar.make_pipeline_train_step(
        stages, jnn.SGD(lr=0.1), mesh, (mb_global,) + shape,
        num_microbatches=num_mb, input_dtype=jax.numpy.float32,
        data_axis="data" if dp > 1 else None)
    state = init_fn(jax.random.PRNGKey(seed))
    params, net = {}, {}
    for part, sv in zip(parts, pipe.unpack_stage_variables(
            state.params, state.net_state)):
        for k, v in sv["params"].items():
            params[_global_key(part, k)] = v
        for k, v in sv["state"].items():
            net[_global_key(part, k)] = v
    return _np(params), _np(net)


PIPE_SHAPE = (8, 8, 3)


@pytest.fixture(scope="module")
def jax_pipe_run(tmp_path_factory):
    """JAX's ``{"pipe": 4}`` run (SGD with momentum): its initial
    per-layer weights, history, final trees and snapshot directory."""
    d = tmp_path_factory.mktemp("jax_pipe")
    jmodel = _conv_bn_net()
    cfg = dict(BASE, mesh_axes={"pipe": 4}, num_microbatches=4,
               optimizer={"type": "sgd", "lr": 0.05 / 4, "momentum": 0.9},
               snapshot_dir=str(d))
    init = _jax_pipeline_init(jmodel, 4, 1, 4, PIPE_SHAPE, 4)
    state, hist = jtrain(jmodel, JConfig().update(cfg),
                         *_loaders(JLoader, PIPE_SHAPE, 10))
    final = {"params": np.asarray(state.params),
             "velocity": np.asarray(state.opt_state["velocity"]),
             "net_state": np.asarray(state.net_state),
             "step": int(state.step)}
    return init, hist, final, d


def _port_pipe_cfg(tmp_path, **kw):
    return TrainingConfig().update(dict(
        BASE, mesh_axes={"pipe": 4}, num_microbatches=4,
        optimizer={"type": "sgd", "lr": 0.05, "momentum": 0.9},
        snapshot_dir=str(tmp_path), **kw))


def test_train_model_pipeline_matches_jax(jax_pipe_run, tmp_path):
    init, jhist, final, _ = jax_pipe_run
    model = _port_model(_conv_bn_net(), PIPE_SHAPE, *init)
    state, hist = train_model(model, _port_pipe_cfg(tmp_path),
                              *_loaders(ArrayDataLoader, PIPE_SHAPE, 10),
                              devices=CPU8)
    trees = train_state_trees(state)
    np.testing.assert_allclose(trees["params"].numpy(), final["params"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(trees["net_state"].numpy(),
                               final["net_state"], rtol=1e-5, atol=1e-6)
    for got, want in zip(hist, jhist):
        for key in ("train_loss", "val_loss"):
            assert got[key] == pytest.approx(want[key], rel=1e-5), key
    # the trained weights are written back into the model
    assert state.step == final["step"] == 6
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.listdir(jax_pipe_run[3]))
    restored = model.jax_param_tree()
    assert set(restored) == set(init[0])


def test_data_pipe_train_model_matches_jax(tmp_path):
    """``{"data": 2, "pipe": 4}``: each data rank pipelines its half of
    every microbatch (its own BatchNorm statistics, the running ones
    averaged), as JAX's program does."""
    jmodel = _conv_bn_net()
    init = _jax_pipeline_init(jmodel, 4, 2, 4, PIPE_SHAPE, 4)
    cfg = dict(BASE, mesh_axes={"data": 2, "pipe": 4}, num_microbatches=4,
               epochs=1)
    jstate, jhist = jtrain(jmodel, JConfig().update(dict(
        cfg, optimizer={"type": "sgd", "lr": 0.1 / 8},
        snapshot_dir=str(tmp_path / "jax"))),
        *_loaders(JLoader, PIPE_SHAPE, 10))
    model = _port_model(jmodel, PIPE_SHAPE, *init)
    state, hist = train_model(model, TrainingConfig().update(dict(
        cfg, optimizer={"type": "sgd", "lr": 0.1},
        snapshot_dir=str(tmp_path / "port"))),
        *_loaders(ArrayDataLoader, PIPE_SHAPE, 10), devices=CPU8)
    trees = train_state_trees(state)
    np.testing.assert_allclose(trees["params"].numpy(),
                               np.asarray(jstate.params), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(trees["net_state"].numpy(),
                               np.asarray(jstate.net_state), rtol=1e-5,
                               atol=1e-6)
    assert hist[0]["train_loss"] == pytest.approx(jhist[0]["train_loss"],
                                                  rel=1e-5)
    assert hist[0]["val_loss"] == pytest.approx(jhist[0]["val_loss"],
                                                rel=1e-5)


def test_pipeline_checkpoints_cross_packages(jax_pipe_run, tmp_path):
    init, _, final, jdir = jax_pipe_run
    # JAX's snapshot into the port's pipeline state
    model = _port_model(_conv_bn_net(), PIPE_SHAPE, *init)
    latest = Checkpoint(str(jdir)).latest_path()
    state, hist = train_model(
        model, _port_pipe_cfg(tmp_path / "resumed", epochs=0,
                              resume=latest),
        *_loaders(ArrayDataLoader, PIPE_SHAPE, 10), devices=CPU8)
    trees = train_state_trees(state)
    np.testing.assert_array_equal(trees["params"].numpy(), final["params"])
    np.testing.assert_array_equal(
        trees["opt_state"]["velocity"].numpy(), final["velocity"])
    np.testing.assert_array_equal(trees["net_state"].numpy(),
                                  final["net_state"])
    assert state.step == final["step"] and hist == []
    # the port's snapshot into JAX's templates
    model = _port_model(_conv_bn_net(), PIPE_SHAPE, *init)
    state, _ = train_model(model, _port_pipe_cfg(tmp_path / "port",
                                                 epochs=1),
                           *_loaders(ArrayDataLoader, PIPE_SHAPE, 10),
                           devices=CPU8)
    path = os.path.join(Checkpoint(str(tmp_path / "port")).latest_path(),
                        "state.tnn")
    templates = {"params": final["params"],
                 "opt_state": {"velocity": final["velocity"],
                               "step": np.zeros((), np.int32)},
                 "net_state": final["net_state"]}
    loaded, _ = jckpt.load_tensors(path, templates)
    mine = train_state_trees(state)
    np.testing.assert_array_equal(np.asarray(loaded["params"]),
                                  mine["params"].numpy())
    np.testing.assert_array_equal(
        np.asarray(loaded["opt_state"]["velocity"]),
        mine["opt_state"]["velocity"].numpy())
    assert int(loaded["opt_state"]["step"]) == 3


def test_pipeline_config_checks(tmp_path):
    model = _port_model(_conv_bn_net(), PIPE_SHAPE,
                        *_jax_pipeline_init(_conv_bn_net(), 2, 1, 4,
                                            PIPE_SHAPE, 4))
    loaders = _loaders(ArrayDataLoader, PIPE_SHAPE, 10)
    cases = [({"pipe": 2, "fsdp": 2}, {}, "compose with 'data' only"),
             ({"pipe": 2}, {"gradient_accumulation_steps": 2},
              "accumulate over num_microbatches"),
             ({"pipe": 2}, {"num_microbatches": 3}, "not divisible")]
    for axes, extra, msg in cases:
        cfg = TrainingConfig().update(dict(
            BASE, mesh_axes=axes, snapshot_dir=str(tmp_path), **extra))
        with pytest.raises(ValueError, match=msg):
            train_model(model, cfg, *loaders, devices=CPU8)


def test_trainer_cli_mesh_on_cpu(tmp_path, monkeypatch):
    from tnn_tpu_torch.cli import trainer

    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"max_steps": 2, "progress_print_interval":
                               1, "io_dtype": "float32",
                               "compute_dtype": "float32"}))
    history_out = tmp_path / "history.json"
    state, history = trainer.main([
        "--config", str(cfg), "--model", "mnist_cnn", "--dataset",
        "synthetic", "--epochs", "1", "--batch-size", "8",
        "--mesh", "data=2,pipe=2", "--num-microbatches", "2",
        "--mesh-devices", ",".join(["cpu"] * 4), "--device", "cpu",
        "--snapshot-dir", str(tmp_path / "snaps"),
        "--history-out", str(history_out)])
    assert state.step == 2 and np.isfinite(history[0]["train_loss"])
    assert json.loads(history_out.read_text())["device"] == "cpu"
    assert train_state_trees(state)["params"].shape[0] == 2
    # "model" on a conv net: no leaf matches the TP rules, so every leaf
    # replicates and the run trains (JAX's conv case)
    state, history = trainer.main([
        "--config", str(cfg), "--model", "mnist_cnn", "--dataset",
        "synthetic", "--epochs", "1", "--batch-size", "8",
        "--mesh", "data=2,model=2", "--mesh-devices",
        ",".join(["cpu"] * 4), "--device", "cpu",
        "--snapshot-dir", str(tmp_path / "tp")])
    assert state.step == 2 and np.isfinite(history[0]["train_loss"])
    assert state.layout.sharded_names() == []
