"""Port parity: the image readers (``tnn_tpu_torch.data.datasets``), the
loader factory, and the image CLIs on the CPU.

Synthetic files in the reference's own formats (CIFAR-10 / CIFAR-100
binary records, MNIST CSV with and without a header, ``images.npy`` and
PNG class folders, a regression CSV) and scikit-learn's bundled digits go
through both packages: the arrays are equal, and so are the batch orders a
seeded, shuffled loader gives. ``cli.trainer`` and ``cli.inferencer`` run
``mnist_cnn`` under ``TNN_PLATFORM=cpu``.
"""
import json
import os

import numpy as np
import pytest
import torch

from tnn_tpu.data import datasets as jds
from tnn_tpu.data import factory as jfactory
from tnn_tpu_torch.cli import inferencer, trainer
from tnn_tpu_torch.data import datasets as tds
from tnn_tpu_torch.data import factory as tfactory
from tnn_tpu_torch.utils.platform import apply_env_platform


def _records(rng, n, labels):
    """n CIFAR records: ``labels`` label bytes, then 3072 CHW pixels."""
    head = rng.integers(0, 100, (n, labels), dtype=np.uint8)
    return np.concatenate([head, rng.integers(0, 256, (n, 3072),
                                              dtype=np.uint8)], axis=1)


def _same_loaders(a, b, batch=4, epochs=2):
    """Equal samples, shapes and shuffled batch orders."""
    assert len(a) == len(b) and a.data_shape == b.data_shape
    a.shuffle()
    b.shuffle()
    for _ in range(epochs):
        for (da, la), (db, lb) in zip(a.batches(batch), b.batches(batch)):
            np.testing.assert_array_equal(da, db)
            np.testing.assert_array_equal(la, lb)


def test_cifar100_binary(tmp_path):
    rng = np.random.default_rng(0)
    for name, n in (("train.bin", 12), ("test.bin", 6)):
        _records(rng, n, 2).tofile(tmp_path / name)
    for train in (True, False):
        for fine in (True, False):
            _same_loaders(jds.CIFAR100DataLoader(str(tmp_path), train, fine,
                                                 seed=3),
                          tds.CIFAR100DataLoader(str(tmp_path), train, fine,
                                                 seed=3))
    data, labels = tds.load_cifar100_bin(str(tmp_path / "train.bin"))
    raw = np.fromfile(tmp_path / "train.bin", np.uint8).reshape(-1, 3074)
    assert data.shape == (12, 32, 32, 3) and data.dtype == np.float32
    assert data[1, 2, 3, 0] == raw[1, 2 + 2 * 32 + 3] / np.float32(255)
    np.testing.assert_array_equal(labels, raw[:, 1])


def test_cifar10_binary(tmp_path):
    rng = np.random.default_rng(1)
    for name in ("data_batch_1.bin", "data_batch_2.bin", "test_batch.bin"):
        _records(rng, 5, 1).tofile(tmp_path / name)
    for train in (True, False):
        _same_loaders(jds.CIFAR10DataLoader(str(tmp_path), train, seed=4),
                      tds.CIFAR10DataLoader(str(tmp_path), train, seed=4))
    with pytest.raises(FileNotFoundError):
        tds.CIFAR10DataLoader(str(tmp_path / "none"))


def _mnist_csv(path, n, header, seed):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, 10, (n, 1)),
                           rng.integers(0, 256, (n, 784))], axis=1)
    with open(path, "w") as f:
        if header:
            f.write("label," + ",".join(f"p{i}" for i in range(784)) + "\n")
        for r in rows:
            f.write(",".join(str(int(v)) for v in r) + "\n")


@pytest.mark.parametrize("header", [True, False])
def test_mnist_csv(tmp_path, header):
    _mnist_csv(tmp_path / "mnist_train.csv", 10, header, seed=2)
    _same_loaders(jds.MNISTDataLoader(str(tmp_path), seed=5),
                  tds.MNISTDataLoader(str(tmp_path), seed=5))


def _folders(root, classes, per_class, size, seed, png=False):
    rng = np.random.default_rng(seed)
    for c in range(classes):
        d = root / f"class{c}"
        d.mkdir(parents=True)
        imgs = rng.integers(0, 256, (per_class,) + size + (3,),
                            dtype=np.uint8)
        if png:
            from PIL import Image
            for i, img in enumerate(imgs):
                Image.fromarray(img).save(d / f"img{i}.png")
        else:
            np.save(d / "images.npy", imgs)


@pytest.mark.parametrize("eager", [False, True])
def test_image_folder_npy(tmp_path, eager):
    _folders(tmp_path, 3, 4, (8, 8), seed=6)
    _same_loaders(jds.ImageFolderDataLoader(str(tmp_path), (8, 8), seed=7,
                                            eager=eager, num_workers=1),
                  tds.ImageFolderDataLoader(str(tmp_path), (8, 8), seed=7,
                                            eager=eager, num_workers=2))


def test_image_folder_png_and_resize(tmp_path):
    """PNG class folders decode to the same pixels; a resized
    ``images.npy`` set equals the JAX package's numpy bilinear resize."""
    _folders(tmp_path / "png", 2, 3, (8, 8), seed=8, png=True)
    _same_loaders(jds.ImageFolderDataLoader(str(tmp_path / "png"), (8, 8),
                                            seed=9, num_workers=1),
                  tds.ImageFolderDataLoader(str(tmp_path / "png"), (8, 8),
                                            seed=9, num_workers=2), batch=2)
    imgs = np.random.default_rng(10).integers(0, 256, (3, 12, 10, 3),
                                              dtype=np.uint8)
    for size in ((8, 8), (16, 20)):
        np.testing.assert_array_equal(tds._resize_bilinear(imgs, size),
                                      jds._resize_bilinear(imgs, size))
        np.testing.assert_array_equal(tds._resize_nearest(imgs, size),
                                      jds._resize_nearest(imgs, size))
    _folders(tmp_path / "npy", 2, 3, (12, 12), seed=11)
    loader = tds.ImageFolderDataLoader(str(tmp_path / "npy"), (8, 8))
    data, labels = loader.get_batch(6)
    raw = np.load(tmp_path / "npy" / "class1" / "images.npy")
    np.testing.assert_array_equal(
        data[3:], jds._resize_bilinear(raw, (8, 8)) / np.float32(255))
    assert list(labels) == [0, 0, 0, 1, 1, 1]


def test_digits_and_regression(tmp_path):
    for train in (True, False):
        _same_loaders(jds.DigitsDataLoader(train=train, seed=12),
                      tds.DigitsDataLoader(train=train, seed=12), batch=64,
                      epochs=1)
    rng = np.random.default_rng(13)
    np.savetxt(tmp_path / "r.csv", rng.normal(size=(20, 6)), delimiter=",",
               header="a,b,c,d,e,t", comments="")
    a = jds.RegressionCSVDataLoader(str(tmp_path / "r.csv"), num_targets=2)
    b = tds.RegressionCSVDataLoader(str(tmp_path / "r.csv"), num_targets=2)
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(a.labels, b.labels)


def test_factory_names():
    assert tfactory.available() == jfactory.available()
    loader = tfactory.create("synthetic_mnist", num_samples=8, seed=1)
    assert loader.data_shape == (28, 28, 1) and len(loader) == 8


def test_trainer_and_inferencer_cli_on_cpu(tmp_path, monkeypatch, capsys):
    """``cli.trainer`` trains ``mnist_cnn`` on an MNIST CSV for one epoch
    with validation and snapshots; ``cli.inferencer`` reads the best
    snapshot's ``state.tnn`` (with its BatchNorm state) and scores the
    test split."""
    data = tmp_path / "mnist"
    data.mkdir()
    _mnist_csv(data / "mnist_train.csv", 32, True, seed=14)
    _mnist_csv(data / "mnist_test.csv", 16, True, seed=15)
    monkeypatch.setenv("TNN_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    assert apply_env_platform() == torch.device("cpu")
    history_out = tmp_path / "history.json"
    state, history = trainer.main([
        "--model", "mnist_cnn", "--dataset", "mnist", "--data-path",
        str(data), "--epochs", "1", "--batch-size", "8", "--snapshot-dir",
        str(tmp_path / "snaps"), "--history-out", str(history_out)])
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
    assert json.loads(history_out.read_text())["device"] == "cpu"
    assert state.buffers and state.step == 4
    best = tmp_path / "snaps" / "best" / "state.tnn"
    assert best.exists()
    out = inferencer.main(["--model-file", str(best), "--dataset", "mnist",
                           "--data-path", str(data), "--batch-size", "8"])
    assert out["samples"] == 16 and 0.0 <= out["accuracy"] <= 1.0
    assert "accuracy" in capsys.readouterr().out
    monkeypatch.delenv("TNN_PLATFORM")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            apply_env_platform()
    assert os.path.isdir(tmp_path / "snaps" / "step_4")
