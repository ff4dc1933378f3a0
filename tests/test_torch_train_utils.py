"""Port parity: the training slice's helpers against the JAX package.

- The nine schedulers (and SGDR with ``t_mult=2``): each scale at
  t = 0..N within 1e-6 relative + 1e-7 absolute of JAX's (both compute in
  float32; pow / cos round in different libraries); ``from_config`` /
  ``get_config`` / ``state_dict`` round trips and configs equal to JAX's.
- The optimizer registry: configs equal to JAX's, round trips.
- The losses (cross entropy on probabilities, MSE, MAE, Huber) within
  1e-6 relative of JAX's, ``names()`` equal; ``topk_accuracy`` and
  ``perplexity`` equal.
- The loaders: ``SyntheticDataLoader`` data equal to JAX's, a loader
  restored from ``state_dict`` mid-epoch giving the JAX loader's
  unbroken order, ``OpenWebTextDataLoader`` windows equal to JAX's over a
  written uint16 file, ``split_microbatches``, ``prefetch``.
- ``TrainingConfig``: fields and defaults equal to JAX's, the env
  overlay, the JSON overlay, the unknown-key error, the factories.
- ``Env`` / ``load_env_file``, the logger's file sink, the memory
  readings, ``make_sampler`` against JAX's greedy and top-k choices,
  ``make_predict``.
"""
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu.data import loader as jloader
from tnn_tpu.data import token_stream as jts
from tnn_tpu.models import sampling as jsampling
from tnn_tpu.nn import losses as jlosses
from tnn_tpu.nn import metrics as jmetrics
from tnn_tpu.nn import optimizers as jopt
from tnn_tpu.nn import schedulers as jsched
from tnn_tpu.utils import config as jconfig
from tnn_tpu.utils import env as jenv
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.data import loader
from tnn_tpu_torch.data import token_stream
from tnn_tpu_torch.models import sampling
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.nn import losses, metrics, optimizers, schedulers
from tnn_tpu_torch.train import make_predict
from tnn_tpu_torch.utils import config, env, hardware
from tnn_tpu_torch.utils.logging import get_logger

SCHEDULERS = [
    {"type": "noop"},
    {"type": "step", "step_size": 7, "gamma": 0.5},
    {"type": "multistep", "milestones": [5, 17, 30], "gamma": 0.3},
    {"type": "exponential", "gamma": 0.93},
    {"type": "cosine", "t_max": 25, "eta_min_scale": 0.1},
    {"type": "cosine_restarts", "t_0": 6, "t_mult": 1, "eta_min_scale": 0.05},
    {"type": "cosine_restarts", "t_0": 5, "t_mult": 2},
    {"type": "linear_warmup", "warmup": 9, "start_scale": 0.2},
    {"type": "warmup_cosine", "warmup": 5, "t_max": 30,
     "eta_min_scale": 0.1},
    {"type": "reduce_on_plateau", "factor": 0.5, "patience": 2},
]


def _sid(cfg):
    return "-".join(str(v) for v in cfg.values())


@pytest.mark.parametrize("cfg", SCHEDULERS, ids=_sid)
def test_scheduler_scales_match_jax(cfg):
    js, ts = jsched.from_config(cfg), schedulers.from_config(cfg)
    for t in range(40):
        want = float(js.scale(jnp.int32(t)))
        got = ts.scale(t)
        assert got.dtype == torch.float32 and got.ndim == 0
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-7), t


@pytest.mark.parametrize("cfg", SCHEDULERS, ids=_sid)
def test_scheduler_config_and_state_round_trip(cfg):
    ts = schedulers.from_config(cfg)
    assert ts.get_config() == jsched.from_config(cfg).get_config()
    again = schedulers.from_config(ts.get_config())
    assert type(again) is type(ts) and again.get_config() == ts.get_config()
    if ts.host_driven:
        for metric in (1.0, 0.9, 0.95, 0.96, 0.97, 0.99):
            ts.observe(metric)
        assert ts.current_scale() == 0.5
    again.load_state_dict(json.loads(json.dumps(ts.state_dict())))
    assert again.state_dict() == ts.state_dict()


def test_plateau_observes_like_jax():
    js = jsched.ReduceLROnPlateau(factor=0.5, patience=1, min_scale=0.2)
    ts = schedulers.ReduceLROnPlateau(factor=0.5, patience=1, min_scale=0.2)
    for metric in (3.0, 2.0, 2.5, 2.4, 2.6, 2.7, 2.8, 2.9, 1.0):
        assert ts.observe(metric) == js.observe(metric)
        assert float(ts.scale(0)) == float(js.scale(0))
    assert ts.host_driven and ts.current_scale() == js.current_scale() < 1
    with pytest.raises(KeyError, match="unknown scheduler"):
        schedulers.from_config({"type": "nope"})


@pytest.mark.parametrize("cfg", [
    {"type": "sgd", "lr": 0.1, "momentum": 0.9, "nesterov": True},
    {"type": "adam", "lr": 3e-4, "amsgrad": True, "grad_clip_norm": 1.0},
    {"type": "adamw", "lr": 1e-3, "weight_decay": 0.01, "beta2": 0.95}],
    ids=lambda c: c["type"])
def test_optimizer_registry_matches_jax(cfg):
    opt = optimizers.from_config(cfg)
    assert opt.get_config() == jopt.from_config(cfg).get_config()
    again = optimizers.from_config(opt.get_config())
    assert type(again) is type(opt)
    assert again.get_config() == opt.get_config()


def test_optimizer_registry_unknown_raises():
    with pytest.raises(KeyError, match="unknown optimizer"):
        optimizers.from_config({"type": "lamb"})


def _loss_inputs(name):
    rs = np.random.RandomState(0)
    if name == "cross_entropy":
        p = rs.rand(6, 5).astype(np.float32)
        return (p / p.sum(-1, keepdims=True),
                rs.randint(0, 5, 6).astype(np.int32))
    return (rs.randn(6, 5).astype(np.float32) * 2,
            rs.randn(6, 5).astype(np.float32))


@pytest.mark.parametrize("name,kw", [("cross_entropy", {}), ("mse", {}),
                                     ("mae", {}), ("huber", {}),
                                     ("huber", {"delta": 0.5})])
def test_losses_match_jax(name, kw):
    a, b = _loss_inputs(name)
    want = float(jlosses.get(name)(jnp.asarray(a), jnp.asarray(b), **kw))
    got = losses.get({"type": name, **kw})(torch.tensor(a), torch.tensor(b))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_loss_names_and_one_hot_cross_entropy():
    assert losses.names() == jlosses.names()
    p, y = _loss_inputs("cross_entropy")
    onehot = np.eye(5, dtype=np.float32)[y]
    assert float(losses.cross_entropy(torch.tensor(p), torch.tensor(onehot))) \
        == pytest.approx(float(jlosses.cross_entropy(jnp.asarray(p),
                                                     jnp.asarray(y))),
                         rel=1e-6)


@pytest.mark.parametrize("k", [1, 3])
def test_topk_accuracy_and_perplexity_match_jax(k):
    rs = np.random.RandomState(1)
    logits = rs.randn(4, 6, 10).astype(np.float32)
    labels = rs.randint(0, 10, (4, 6)).astype(np.int32)
    labels[0, :2] = -1      # ignored positions
    want = float(jmetrics.topk_accuracy(jnp.asarray(logits),
                                        jnp.asarray(labels), k=k))
    got = metrics.topk_accuracy(torch.tensor(logits), torch.tensor(labels),
                                k=k)
    assert float(got) == pytest.approx(want, abs=1e-7)
    assert float(metrics.perplexity(2.5)) == pytest.approx(
        float(jmetrics.perplexity(jnp.float32(2.5))), rel=1e-6)


def test_synthetic_loader_data_matches_jax():
    j = jloader.SyntheticDataLoader(20, (3, 2), 4, seed=5)
    t = loader.SyntheticDataLoader(20, (3, 2), 4, seed=5)
    np.testing.assert_array_equal(t.data, j.data)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.data_shape == j.data_shape and len(t) == len(j)


def _order(batches):
    return [b[1].tolist() for b in batches]


def test_loader_state_dict_resumes_jax_order():
    """A loader restored mid-epoch from ``state_dict`` (through JSON, as a
    checkpoint's meta carries it) yields the rest of the JAX loader's
    unbroken order, and the next epoch's reshuffle too."""
    data = np.arange(26, dtype=np.float32)[:, None]
    labels = np.arange(26, dtype=np.int32)
    jl = jloader.ArrayDataLoader(data, labels, seed=3)
    jl.shuffle()
    want = _order(jl.batches(4, reset=False)) + _order(jl.batches(4))
    tl = loader.ArrayDataLoader(data, labels, seed=3)
    tl.shuffle()
    it = tl.batches(4, reset=False)
    got = _order([next(it), next(it)])
    assert tl.remaining_batches(4) == 4 and tl.steps_per_epoch(4) == 6
    saved = json.loads(json.dumps(tl.state_dict()))
    fresh = loader.ArrayDataLoader(data, labels, seed=99)
    fresh.load_state_dict(saved)
    got += _order(fresh.batches(4, reset=False)) + _order(fresh.batches(4))
    assert got == want


def test_loader_remainder_and_split_microbatches():
    data = np.arange(10, dtype=np.float32)
    tl = loader.ArrayDataLoader(data, data.astype(np.int32))
    sizes = [len(b[0]) for b in tl.batches(4, drop_remainder=False)]
    assert sizes == [4, 4, 2] and tl.remaining_batches(4) == 0
    mbs = loader.split_microbatches(data[:8], data[:8], 4)
    assert [m[0].tolist() for m in mbs] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="not divisible"):
        loader.split_microbatches(data, data, 4)


def test_prefetch_stages_stops_and_raises():
    batches = [(np.full((2, 3), i, np.float32), np.full(2, i, np.int32))
               for i in range(5)]
    out = list(loader.prefetch(iter(batches), size=2, to_device="cpu"))
    assert [int(d[0, 0]) for d, _ in out] == list(range(5))
    assert all(isinstance(d, torch.Tensor) and d.dtype == torch.float32
               and lab.dtype == torch.int32 for d, lab in out)
    # a consumer that stops early stops the producer
    it = loader.prefetch(iter(batches), size=1, to_device=False)
    first = next(it)
    it.close()
    assert isinstance(first[0], np.ndarray)

    def broken():
        yield batches[0]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(loader.prefetch(broken(), to_device=lambda b: b))


def test_openwebtext_windows_match_jax(tmp_path):
    path = tmp_path / "train.bin"
    np.random.default_rng(0).integers(0, 50257, 300).astype(
        np.uint16).tofile(path)
    jl = jts.OpenWebTextDataLoader(str(path), context_length=16, seed=2)
    tl = token_stream.OpenWebTextDataLoader(str(path), context_length=16,
                                            seed=2)
    assert len(tl) == len(jl) == 284 and tl.data_shape == (16,)
    jl.shuffle()
    tl.shuffle()
    for (jd, jy), (td, ty) in zip(jl.batches(8), tl.batches(8)):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(ty, jy)
        assert td.dtype == np.int32


def test_training_config_fields_env_and_json(tmp_path, monkeypatch):
    assert config.TrainingConfig().to_dict() == \
        jconfig.TrainingConfig().to_dict()
    for k, v in {"EPOCHS": "3", "BATCH_SIZE": "16", "LR_INITIAL": "0.01",
                 "PRINT_MEMORY_USAGE": "yes", "PROFILER_TYPE": "normal",
                 "LOSS": "mse", "MAX_STEPS": "bad"}.items():
        monkeypatch.setenv(k, v)
    t = config.TrainingConfig().load_from_env()
    assert t.to_dict() == jconfig.TrainingConfig().load_from_env().to_dict()
    assert (t.epochs, t.batch_size, t.lr_initial, t.print_memory_usage,
            t.profiler_type, t.loss, t.max_steps) == \
        (3, 16, 0.01, True, "NORMAL", "mse", -1)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"epochs": 2, "optimizer": {"type": "adamw"},
                                "scheduler": {"type": "step",
                                              "step_size": 3}}))
    t.load_from_json(str(path))
    assert t.epochs == 2
    opt = t.make_optimizer()
    assert isinstance(opt, optimizers.AdamW) and opt.lr == 0.01
    assert isinstance(t.make_scheduler(), schedulers.StepLR)
    assert isinstance(config.TrainingConfig().make_scheduler(),
                      schedulers.NoOp)
    assert t.make_policy() == tdt.MIXED_BF16
    path.write_text(json.dumps({"epochz": 2}))
    with pytest.raises(KeyError, match="unknown TrainingConfig keys"):
        t.load_from_json(str(path))


def test_env_file_and_typed_get(tmp_path, monkeypatch):
    path = tmp_path / ".env"
    path.write_text("# comment\nTNN_A=1 # inline\nTNN_B='x # y'\n"
                    "bad key=3\nTNN_C=\"on\"\n")
    want = jenv.load_env_file(str(path), export=False)
    assert env.load_env_file(str(path), export=False) == want
    env.load_env_file(str(path))
    assert env.Env.get("TNN_A", 0) == 1 and env.Env.get("TNN_C", False)
    assert env.Env.get("TNN_B", "") == "x # y"
    assert env.Env.get("TNN_MISSING", 7) == 7 and env.Env.has("TNN_A")
    for k in ("TNN_A", "TNN_B", "TNN_C"):
        monkeypatch.delenv(k)


def test_logger_file_sink_and_timer(tmp_path):
    log = get_logger("tnn.test_port_utils")
    path = tmp_path / "run.log"
    log.set_file_sink(str(path))
    log.info("hello %d", 3)
    with log.timed("block"):
        pass
    log.set_file_sink(None)
    text = path.read_text()
    assert "hello 3" in text and "block took" in text
    assert get_logger("tnn.test_port_utils") is log
    assert not any(isinstance(h, logging.FileHandler)
                   for h in logging.getLogger("tnn.test_port_utils").handlers)


def test_memory_readings():
    assert hardware.memory_usage_kb() > 0
    assert hardware.device_memory_stats("cpu") == {}


def test_make_sampler_matches_jax_greedy_and_top_k():
    rs = np.random.RandomState(2)
    logits = rs.randn(6, 50).astype(np.float32)
    want = np.asarray(jsampling.make_sampler()(jnp.asarray(logits), None))
    greedy = sampling.make_sampler()
    assert greedy(torch.tensor(logits)).tolist() == want.tolist()
    gen = torch.Generator().manual_seed(0)
    top1 = sampling.make_sampler(temperature=0.8, top_k=1)
    assert top1(torch.tensor(logits), gen).tolist() == want.tolist()
    jtop1 = jsampling.make_sampler(temperature=0.8, top_k=1)
    assert np.asarray(jtop1(jnp.asarray(logits), jax.random.PRNGKey(0))) \
        .tolist() == want.tolist()
    top3 = sampling.make_sampler(temperature=1.0, top_k=3)
    allowed = np.argsort(logits, axis=-1)[:, -3:]
    for _ in range(5):
        got = top3(torch.tensor(logits), gen).numpy()
        assert all(g in a for g, a in zip(got, allowed))
    rows = sampling.make_sampler(temperature=torch.tensor([0.0] * 6))
    assert rows(torch.tensor(logits), gen).tolist() == want.tolist()


def test_make_predict_is_the_forward():
    model = GPT2(vocab_size=64, max_len=16, num_layers=1, d_model=16,
                 num_heads=2, policy=tdt.FP32, device="cpu", seed=0)
    ids = torch.arange(8)[None]
    out = make_predict(model)(ids)
    assert not out.requires_grad
    torch.testing.assert_close(out, model(ids).detach(), rtol=0, atol=0)
