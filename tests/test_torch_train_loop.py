"""Port parity: ``train_model``, the training ``Checkpoint`` and ``remat``
against the JAX package, on the tiny FP32 GPT-2 (2 layers, d 32, vocab
128) over an ``ArrayDataLoader`` of token windows.

- ``train_model`` started from JAX's initial weights (``state=``), with
  shuffling, validation, AdamW and StepLR from the config, dropout 0:
  every epoch's train and validation loss within 1e-5 relative of JAX's
  ``train_model``, the same snapshot directories.
- Resume: a run cut after 3 of 8 batches (``max_steps``) and resumed from
  its snapshot equals an unbroken run bit for bit, with dropout 0.1 (the
  restored generator state gives the same masks); the cut run's loader
  cursor stops at exactly 3 batches.
- A JAX-written checkpoint directory restores into the port: params,
  Adam moments and step equal JAX's final state.
- ``Checkpoint``: retention, ``best/``, a torn step directory (no
  ``meta.json``) ignored, an async failure raised by ``wait()``, a
  restored state byte-equal to the saved one.
- The plateau scheduler observes the validation loss as JAX's does.
- ``remat``: every policy with dropout 0.1 equal to no remat bit for bit;
  "full" runs the forward's products again in the backward, the "dots"
  policies do not (counted ops); a typo raises.
- The profiler modes, and the ``mesh_axes`` layouts ``train_model``
  refuses with the JAX loop's messages: an unknown axis, "pipe" with
  "model", "seq" on a model with no attention, S not divisible by seq,
  "expert" on a model with no MoE (the layouts themselves run in
  ``test_torch_train_parallel.py`` and ``test_torch_parallel_axes.py``).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tnn_tpu.core import dtypes as jdt
from tnn_tpu.data.loader import ArrayDataLoader as JLoader
from tnn_tpu.models.gpt2 import GPT2 as JGPT2
from tnn_tpu.nn import optimizers as jopt
from tnn_tpu.train import create_train_state as jcreate
from tnn_tpu.train import train_model as jtrain
from tnn_tpu.utils.config import TrainingConfig as JConfig
from tnn_tpu_torch.checkpoint import Checkpoint, read_tensor_file
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.data.loader import ArrayDataLoader
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.nn import schedulers
from tnn_tpu_torch.nn.optimizers import AdamW
from tnn_tpu_torch.profiling import GlobalProfiler
from tnn_tpu_torch.train import (create_train_state, make_train_step,
                                 train_model, train_state_trees)
from tnn_tpu_torch.utils.config import TrainingConfig

TINY = dict(vocab_size=128, max_len=32, num_layers=2, d_model=32,
            num_heads=2)
CFG = dict(epochs=2, batch_size=4, progress_print_interval=3,
           optimizer={"type": "adamw", "lr": 1e-3},
           scheduler={"type": "step", "step_size": 5, "gamma": 0.5},
           io_dtype="float32", compute_dtype="float32", seed=0)


def _windows():
    toks = np.random.default_rng(0).integers(0, 128, (40, 17)).astype(
        np.int32)
    return toks[:, :-1], toks[:, 1:]


def _loaders(loader_cls):
    data, labels = _windows()
    return (loader_cls(data[:32], labels[:32]),
            loader_cls(data[32:], labels[32:]))


def _port_model(params=None, dropout=0.0, seed=0):
    model = GPT2(**TINY, dropout=dropout, policy=tdt.FP32, device="cpu",
                 seed=seed if params is None else None)
    if params is not None:
        model.load_jax_params(params)
    return model


def _cfg(directory, **kw):
    return TrainingConfig().update({**CFG, "snapshot_dir": str(directory),
                                    **kw})


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's ``train_model``: its initial params, history, final state and
    snapshot directory."""
    d = tmp_path_factory.mktemp("jax_run")
    model = JGPT2(**TINY, policy=jdt.FP32)
    opt = jopt.from_config(CFG["optimizer"])
    state = jcreate(model, opt, jax.random.PRNGKey(0), (4, 16))
    params0 = jax.tree.map(np.asarray, state.params)
    cfg = JConfig().update({**CFG, "snapshot_dir": str(d)})
    state, history = jtrain(model, cfg, *_loaders(JLoader), state=state)
    final = {"params": jax.tree.map(np.asarray, state.params),
             "m": jax.tree.map(np.asarray, state.opt_state["m"]),
             "step": int(state.step)}
    return params0, history, final, d


def test_train_model_matches_jax(jax_run, tmp_path):
    params0, jhist, _, jdir = jax_run
    model = _port_model(params0)
    hooks = []
    state, hist = train_model(
        model, _cfg(tmp_path), *_loaders(ArrayDataLoader),
        metric_hook=lambda step, m: hooks.append(step),
        state_hook=lambda st: hooks.append("state"))
    assert len(hist) == len(jhist) == 2
    for got, want in zip(hist, jhist):
        assert got["batches"] == want["batches"] == 8
        for key in ("train_loss", "val_loss"):
            assert got[key] == pytest.approx(want[key], rel=1e-5), key
    assert state.step == 16
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(jdir))
    assert [h for h in hooks if h != "state"] == [3, 6, 11, 14]
    assert hooks.count("state") == 1 + 4 + 2


def test_restores_a_jax_checkpoint(jax_run):
    _, _, final, jdir = jax_run
    model = _port_model(seed=5)
    state = create_train_state(model, AdamW(lr=1e-3))
    state, meta = Checkpoint(str(jdir)).restore(state)
    assert state.step == final["step"] == meta["step"] == 16
    trees = train_state_trees(state)
    for a, b in zip(jax.tree.leaves(final["params"]),
                    jax.tree.leaves(trees["params"])):
        np.testing.assert_array_equal(b.numpy(), a)
    for a, b in zip(jax.tree.leaves(final["m"]),
                    jax.tree.leaves(trees["opt_state"]["m"])):
        np.testing.assert_array_equal(b.numpy(), a)
    assert int(trees["opt_state"]["step"]) == 16
    # the JAX key seeds the generator by the documented rule
    key = read_tensor_file(os.path.join(jdir, "step_16", "state.tnn"))[0][
        "rng"].numpy().astype(np.uint64)
    want = torch.Generator().manual_seed(int(key[0]) << 32 | int(key[1]))
    assert torch.equal(state.generator.get_state(), want.get_state())


def _flat(state):
    return torch.cat([p.detach().flatten() for p in state.params.values()])


def test_resume_mid_epoch_equals_unbroken_run(tmp_path):
    model = _port_model(dropout=0.1)
    full, _ = train_model(model, _cfg(tmp_path / "full", epochs=1),
                          *_loaders(ArrayDataLoader))
    model = _port_model(dropout=0.1)
    train, val = _loaders(ArrayDataLoader)
    cut, hist = train_model(model, _cfg(tmp_path / "cut", epochs=1,
                                        max_steps=3), train, val)
    assert hist[0]["batches"] == 3 and cut.step == 3
    # limited at the source: the prefetcher took no batch past the third
    assert train._cursor == 12 and train.remaining_batches(4) == 5
    model = _port_model(seed=7, dropout=0.1)
    resumed, hist = train_model(
        model, _cfg(tmp_path / "resumed", epochs=1,
                    resume=str(tmp_path / "cut" / "step_3")),
        *_loaders(ArrayDataLoader))
    assert hist[0]["batches"] == 5 and resumed.step == 8
    assert torch.equal(_flat(resumed), _flat(full))
    for key in ("m", "v"):
        for name in full.opt_state[key]:
            assert torch.equal(resumed.opt_state[key][name],
                               full.opt_state[key][name])
    assert torch.equal(resumed.generator.get_state(),
                       full.generator.get_state())


def test_checkpoint_retention_best_torn_and_round_trip(tmp_path):
    model = _port_model()
    opt = AdamW(lr=1e-3)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt)
    data, labels = (torch.tensor(a[:4]) for a in _windows())
    ckpt = Checkpoint(str(tmp_path), keep=2)
    sched = schedulers.ReduceLROnPlateau(patience=0)
    sched.observe(2.0)
    sched.observe(3.0)
    for i in range(4):
        state, _ = step(state, data, labels)
        ckpt.save(state, model=model, scheduler=sched, block=i % 2 == 0)
    ckpt.save(state, model=model, extra={"val": 1.5}, best=True)
    ckpt.wait()
    os.makedirs(tmp_path / "step_9")            # torn: no meta.json
    assert sorted(os.listdir(tmp_path)) == ["best", "step_3", "step_4",
                                            "step_9"]
    assert ckpt.latest_path() == str(tmp_path / "step_4")
    meta = json.loads((tmp_path / "best" / "meta.json").read_text())
    assert meta["extra"] == {"val": 1.5}
    assert meta["model_config"] == model.get_config()
    saved = train_state_trees(state)
    fresh = create_train_state(_port_model(seed=3), opt)
    sched2 = schedulers.ReduceLROnPlateau(patience=0)
    fresh, meta = ckpt.restore(fresh, scheduler=sched2)
    assert sched2.state_dict() == sched.state_dict()
    got = train_state_trees(fresh)
    assert fresh.step == 4 and int(got["step"]) == 4
    for a, b in zip(jax.tree.leaves(saved), jax.tree.leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(fresh.generator.get_state(),
                       state.generator.get_state())
    assert Checkpoint(str(tmp_path / "best")).latest_path() == \
        str(tmp_path / "best")


def test_async_save_copies_first_and_raises_on_wait(tmp_path):
    model = _port_model()
    state = create_train_state(model, AdamW())
    ckpt = Checkpoint(str(tmp_path / "ok"))
    ckpt.save(state, block=False)
    before = state.params["wte.table"].detach().clone()
    with torch.no_grad():
        state.params["wte.table"].add_(1.0)   # the next step's update
    ckpt.wait()
    flat, _ = read_tensor_file(str(tmp_path / "ok" / "step_0" /
                                   "state.tnn"))
    assert torch.equal(flat["params/wte/table"], before)
    (tmp_path / "blocked").write_text("a file where the directory goes")
    bad = Checkpoint(str(tmp_path / "blocked"))
    bad.save(state, block=False)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                                # the error is reported once
    with pytest.raises(FileNotFoundError):
        Checkpoint(str(tmp_path / "none")).restore(state)


def test_plateau_scheduler_observes_validation(jax_run, tmp_path):
    params0 = jax_run[0]
    sched_cfg = {"type": "reduce_on_plateau", "factor": 0.5, "patience": 0,
                 "threshold": 10.0}
    jm = JGPT2(**TINY, policy=jdt.FP32)
    jstate = jcreate(jm, jopt.from_config(CFG["optimizer"]),
                     jax.random.PRNGKey(0), (4, 16))
    jstate = jstate._replace(params=jax.tree.map(np.asarray, params0))
    from tnn_tpu.nn import schedulers as jsched
    js = jsched.from_config(sched_cfg)
    jcfg = JConfig().update({**CFG, "epochs": 3, "scheduler": sched_cfg,
                             "snapshot_dir": str(tmp_path / "j")})
    _, jhist = jtrain(jm, jcfg, *_loaders(JLoader), scheduler=js,
                      state=jstate)
    ts = schedulers.from_config(sched_cfg)
    _, hist = train_model(_port_model(params0),
                          _cfg(tmp_path / "t", epochs=3,
                               scheduler=sched_cfg),
                          *_loaders(ArrayDataLoader), scheduler=ts)
    assert ts.current_scale() == js.current_scale() == 0.25
    for got, want in zip(hist, jhist):
        assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-5)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _remat_run(remat):
    model = _port_model(dropout=0.1)
    opt = AdamW(lr=1e-3)
    state = create_train_state(model, opt, seed=3)
    step = make_train_step(model, opt, remat=remat)
    data, labels = (torch.tensor(a[:4]) for a in _windows())
    losses = []
    with _CountOps() as ops:
        for _ in range(2):
            state, m = step(state, data, labels)
            losses.append(float(m["loss"]))
    return losses, _flat(state), ops.counts


@pytest.fixture(scope="module")
def no_remat():
    return _remat_run(False)


@pytest.mark.parametrize("remat", [True, "full", "dots", "dots_no_batch",
                                   "offload_dots"])
def test_remat_equals_no_remat_bit_for_bit(no_remat, remat):
    losses, params, counts = _remat_run(remat)
    base_losses, base_params, base = no_remat
    assert losses == base_losses and torch.equal(params, base_params)
    if remat in (True, "full"):
        # the backward runs the forward's products again
        assert counts["mm"] > base["mm"] and counts["bmm"] > base["bmm"]
    elif remat == "dots":
        assert counts["mm"] == base["mm"] and counts["bmm"] == base["bmm"]
    else:
        # batched products (attention scores) are recomputed, the
        # projections replayed from what the forward kept
        assert counts["mm"] == base["mm"] and counts["bmm"] > base["bmm"]


def test_remat_typo_raises():
    model = _port_model()
    with pytest.raises(ValueError, match="unknown remat policy"):
        make_train_step(model, AdamW(), remat="dot")


@pytest.mark.parametrize("mode", ["NORMAL", "CUMULATIVE"])
def test_profiler_modes(tmp_path, mode):
    _port = _port_model()
    train_model(_port, _cfg(tmp_path, epochs=1, max_steps=2,
                            profiler_type=mode),
                *_loaders(ArrayDataLoader))
    if mode == "NORMAL":
        assert GlobalProfiler.summary()["train_step/epoch0"]["count"] == 2
    else:
        assert GlobalProfiler.counters["train_step"] > 0
        assert GlobalProfiler.summary() == {}


def _no_attention_model():
    from tnn_tpu_torch.nn import Dense, Embedding, Sequential

    return Sequential([Embedding(128, 8, device=None),
                       Dense(None, 128)]).init((16,), device="cpu")


@pytest.mark.parametrize("axis", ["model", "seq", "expert"])
def test_mesh_axes_refused(tmp_path, axis):
    cases = {
        "model": [(_port_model(), {"model": 2, "pipe": 2},
                   "compose with 'data' only"),
                  (_port_model(), {"tensor": 2}, "handles data/fsdp/model")],
        "seq": [(_no_attention_model(), {"seq": 2},
                 "no attention modules"),
                (_port_model(), {"seq": 3}, "not divisible by")],
        "expert": [(_port_model(), {"data": 2, "expert": 2},
                    "no MoE expert parameters")],
    }[axis]
    for model, axes, msg in cases:
        with pytest.raises(ValueError, match=msg):
            train_model(model, _cfg(tmp_path, mesh_axes=axes),
                        *_loaders(ArrayDataLoader), devices=["cpu"] * 4)
