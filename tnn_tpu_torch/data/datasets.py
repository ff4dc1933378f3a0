"""Dataset readers (``tnn_tpu.data.datasets``): MNIST CSV, CIFAR-10/100
binaries, image folders, the bundled handwritten digits and regression
CSVs.

Every image reader gives NHWC float32 in [0, 1] and int32 class labels;
normalization runs on the device (``data.augmentation``). Where the native
runtime is built (``native``), the MNIST CSV and CIFAR parsers, an image
folder's PNG / JPEG decoding and its bilinear resizes run there, threaded,
as in the JAX package; numpy (and PIL for other image files, or a variant
the native decoders refuse) is the path without it. Loaders that need a
package the card's image lacks (scikit-learn for the digits, PIL for
image files off the native path) import it when they are used and raise
a clear error without it.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..utils import affinity
from .loader import ArrayDataLoader, DataLoader

# -- MNIST (CSV: label,p0,...,p783 per row) ----------------------------------


def load_mnist_csv(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 28, 28, 1) float32 in [0, 1] and (N,) int32 labels: the native
    parser's where the runtime is built (it declines float pixels, which
    ``np.loadtxt`` reads)."""
    if native.available():
        try:
            imgs, labels = native.api.mnist_csv(path,
                                                header=bool(_has_header(path)))
            return (imgs.astype(np.float32) / 255.0).reshape(-1, 28, 28, 1), \
                labels
        except ValueError:
            pass
    raw = np.loadtxt(path, delimiter=",", skiprows=_has_header(path),
                     dtype=np.float32)
    labels = raw[:, 0].astype(np.int32)
    data = (raw[:, 1:] / 255.0).reshape(-1, 28, 28, 1).astype(np.float32)
    return data, labels


def _has_header(path: str) -> int:
    """1 if the first line's first field is not a number, else 0."""
    with open(path, "r") as f:
        first = f.readline()
    try:
        float(first.split(",")[0].strip())
        return 0
    except ValueError:
        return 1


class MNISTDataLoader(ArrayDataLoader):
    """MNIST from ``mnist_train.csv`` / ``mnist_test.csv`` under ``path``
    (or the CSV ``path`` itself)."""

    def __init__(self, path: str, train: bool = True, seed: int = 0):
        name = "mnist_train.csv" if train else "mnist_test.csv"
        full = path if path.endswith(".csv") else os.path.join(path, name)
        data, labels = load_mnist_csv(full)
        super().__init__(data, labels, seed)


# -- CIFAR-10 / CIFAR-100 binary ---------------------------------------------

_CIFAR_HW = 32
_CIFAR_PIXELS = 3 * _CIFAR_HW * _CIFAR_HW  # 3072, stored CHW


def load_cifar10_bin(files: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 batches: 1 label byte + 3072 CHW pixel bytes a record."""
    datas, labels = [], []
    for f in files:
        if native.available():
            imgs, labs = native.api.cifar10(f)
            datas.append(imgs.astype(np.float32) / 255.0)
            labels.append(labs)
            continue
        raw = np.fromfile(f, dtype=np.uint8).reshape(-1, 1 + _CIFAR_PIXELS)
        labels.append(raw[:, 0].astype(np.int32))
        datas.append(_chw_bytes_to_nhwc(raw[:, 1:]))
    return np.concatenate(datas), np.concatenate(labels)


def load_cifar100_bin(file: str, fine_labels: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-100: coarse byte + fine byte + 3072 CHW pixel bytes a
    record."""
    if native.available():
        imgs, coarse, fine = native.api.cifar100(file)
        return imgs.astype(np.float32) / 255.0, \
            (fine if fine_labels else coarse)
    raw = np.fromfile(file, dtype=np.uint8).reshape(-1, 2 + _CIFAR_PIXELS)
    labels = raw[:, 1 if fine_labels else 0].astype(np.int32)
    return _chw_bytes_to_nhwc(raw[:, 2:]), labels


def _chw_bytes_to_nhwc(flat: np.ndarray) -> np.ndarray:
    chw = flat.reshape(flat.shape[0], 3, _CIFAR_HW, _CIFAR_HW)
    return chw.transpose(0, 2, 3, 1).astype(np.float32) / 255.0


class CIFAR10DataLoader(ArrayDataLoader):
    """CIFAR-10 from ``data_batch_{1..5}.bin`` / ``test_batch.bin``."""

    def __init__(self, path: str, train: bool = True, seed: int = 0):
        if train:
            files = [os.path.join(path, f"data_batch_{i}.bin")
                     for i in range(1, 6)]
            files = [f for f in files if os.path.exists(f)]
            if not files:
                raise FileNotFoundError(
                    f"no CIFAR-10 data_batch_*.bin under {path}")
        else:
            files = [os.path.join(path, "test_batch.bin")]
        data, labels = load_cifar10_bin(files)
        super().__init__(data, labels, seed)


class CIFAR100DataLoader(ArrayDataLoader):
    """CIFAR-100 from ``train.bin`` / ``test.bin`` (fine labels, 100
    classes)."""

    def __init__(self, path: str, train: bool = True,
                 fine_labels: bool = True, seed: int = 0):
        f = os.path.join(path, "train.bin" if train else "test.bin")
        data, labels = load_cifar100_bin(f, fine_labels)
        super().__init__(data, labels, seed)


# -- Image folders (TinyImageNet layout) -------------------------------------

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")
_NATIVE_IMG_EXTS = (".png", ".jpg", ".jpeg")   # the native decoders' formats


class ImageFolderDataLoader(DataLoader):
    """A class-per-directory tree as NHWC float32 batches. Layouts:
    ``<class>/img.png``, TinyImageNet's ``<class>/images/img.JPEG`` and
    ``<class>/images.npy`` arrays (uint8, or floats in [0, 1]). Only the
    (item, label) index is built at construction; pixels are read per
    batch (``eager=True`` caches the decoded uint8 set). Class order is
    ``class_names`` or the sorted directory names. Images of another size
    are resized to ``image_size`` (bilinear, align-corners off, or
    nearest). Under bilinear sampling with the native runtime built, PNG
    and JPEG files decode and resize natively, a batch's files in one
    threaded call, and ``images.npy`` blocks resize there too; a file the
    native decoders refuse, and every file otherwise, decodes through PIL
    on a pool of threads pinned to the IO cpu set under ``TNN_PIN_IO=1``
    (``utils.affinity``)."""

    def __init__(self, path: str, image_size: Tuple[int, int] = (64, 64),
                 seed: int = 0,
                 class_names: Optional[Sequence[str]] = None,
                 eager: bool = False, num_workers: Optional[int] = None,
                 resample: str = "bilinear"):
        super().__init__(seed)
        if num_workers is None:
            num_workers = min(8, max(1, (os.cpu_count() or 2) - 1))
        self.num_workers = int(num_workers)
        self.resample = resample
        self._pool: Optional[ThreadPoolExecutor] = None
        self._native_img = native.available() and resample == "bilinear"
        names = list(class_names) if class_names is not None else sorted(
            d for d in os.listdir(path)
            if os.path.isdir(os.path.join(path, d)))
        self.class_names = names
        self.image_size = tuple(image_size)
        self._items: list = []          # (kind, payload) per sample
        labels = []
        self._npy_cache: dict = {}
        for ci, cname in enumerate(names):
            cdir = os.path.join(path, cname)
            npy = os.path.join(cdir, "images.npy")
            if os.path.exists(npy):
                n = len(np.load(npy, mmap_mode="r"))
                self._items += [("npy", (npy, i)) for i in range(n)]
                labels += [ci] * n
                continue
            nested = os.path.join(cdir, "images")
            imgdir = nested if os.path.isdir(nested) else cdir
            files = sorted(f for f in os.listdir(imgdir)
                           if f.lower().endswith(_IMG_EXTS))
            if not files:
                raise FileNotFoundError(f"class dir {cdir} has no "
                                        f"{_IMG_EXTS} images or images.npy")
            self._items += [("img", os.path.join(imgdir, f)) for f in files]
            labels += [ci] * len(files)
        self._labels = np.asarray(labels, np.int32)
        self._num_samples = len(self._items)
        self._data_shape = self.image_size + (3,)
        self._label_shape = ()
        self._eager_cache: Optional[np.ndarray] = None
        if eager:
            self._eager_cache = self._decode_all(range(self._num_samples))

    def _npy(self, path):
        if path not in self._npy_cache:
            self._npy_cache[path] = np.load(path, mmap_mode="r")
        return self._npy_cache[path]

    def _resize(self, block: np.ndarray) -> np.ndarray:
        if block.shape[1:3] == self.image_size:
            return block
        if self._native_img:
            return native.api.resize_bilinear_batch(block, *self.image_size)
        resize = _resize_bilinear if self.resample == "bilinear" \
            else _resize_nearest
        return resize(block, self.image_size)

    def _decode_file(self, path: str) -> np.ndarray:
        return _decode_image_pil(path, self.image_size, self.resample)

    def _native_file(self, path: str) -> bool:
        return self._native_img and path.lower().endswith(_NATIVE_IMG_EXTS)

    def _decode_all(self, indices) -> np.ndarray:
        """uint8 (N, H, W, 3) of the samples at ``indices``: the rows of
        each ``images.npy`` in one read and one resize, the native
        runtime's files in one call, the rest on the decode pool."""
        idx = [int(i) for i in indices]
        slots: list = [None] * len(idx)
        by_file: dict = {}
        for j, i in enumerate(idx):
            kind, payload = self._items[i]
            if kind == "npy":
                by_file.setdefault(payload[0], []).append((j, payload[1]))
        for path, entries in by_file.items():
            block = np.asarray(self._npy(path)[np.asarray(
                [r for _, r in entries])])
            if block.dtype != np.uint8:
                block = np.clip(block * 255.0, 0, 255).astype(np.uint8)
            for (j, _), frame in zip(entries, self._resize(block)):
                slots[j] = frame
        nat = [j for j in range(len(idx)) if slots[j] is None
               and self._native_file(self._items[idx[j]][1])]
        if nat:
            out, ok = native.api.decode_image_batch(
                [self._items[idx[j]][1] for j in nat], *self.image_size)
            for j, frame, good in zip(nat, out, ok):
                if good:        # a refused variant decodes through PIL
                    slots[j] = frame
        files = [j for j in range(len(idx)) if slots[j] is None]
        paths = [self._items[idx[j]][1] for j in files]
        if self.num_workers > 1 and len(files) > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    self.num_workers, thread_name_prefix="tnn-decode",
                    initializer=affinity.pin_io_thread)
            frames = list(self._pool.map(self._decode_file, paths))
        else:
            frames = [self._decode_file(p) for p in paths]
        for j, frame in zip(files, frames):
            slots[j] = frame
        return np.stack(slots)

    def _get(self, indices):
        batch = self._eager_cache[indices] if self._eager_cache is not None \
            else self._decode_all(indices)
        return batch.astype(np.float32) / 255.0, self._labels[indices]

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)


def _resize_nearest(imgs: np.ndarray, image_size) -> np.ndarray:
    H, W = image_size
    yi = np.arange(H) * imgs.shape[1] // H
    xi = np.arange(W) * imgs.shape[2] // W
    return imgs[:, yi[:, None], xi[None, :], :]


def _resize_bilinear(imgs: np.ndarray, image_size) -> np.ndarray:
    """Bilinear resize of (N, H, W, C) uint8, align-corners off."""
    _, H0, W0, _ = imgs.shape
    H, W = image_size
    if (H0, W0) == (H, W):
        return imgs
    ys = (np.arange(H) + 0.5) * H0 / H - 0.5
    xs = (np.arange(W) + 0.5) * W0 / W - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, H0 - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W0 - 1)
    y1 = np.minimum(y0 + 1, H0 - 1)
    x1 = np.minimum(x0 + 1, W0 - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[None, :, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, None, :, None]
    f = imgs.astype(np.float32)
    fy0, fy1 = f[:, y0], f[:, y1]
    top = fy0[:, :, x0] * (1 - wx) + fy0[:, :, x1] * wx
    bot = fy1[:, :, x0] * (1 - wx) + fy1[:, :, x1] * wx
    out = top * (1 - wy) + bot * wy
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def _decode_image_pil(path: str, image_size,
                      resample: str = "bilinear") -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"PIL is not installed, so {path} cannot be "
                          "decoded; provide <class>/images.npy instead") from e
    sampling = getattr(Image, "Resampling", Image)
    rs = sampling.BILINEAR if resample == "bilinear" else sampling.NEAREST
    img = Image.open(path).convert("RGB")
    if img.size != (image_size[1], image_size[0]):
        img = img.resize((image_size[1], image_size[0]), rs)
    return np.asarray(img, np.uint8)


# -- scikit-learn's bundled handwritten digits --------------------------------


class DigitsDataLoader(ArrayDataLoader):
    """The 1,797 real 8 x 8 handwritten digits bundled with scikit-learn,
    upscaled (bilinear) to ``image_size`` and replicated to 3 channels, so
    the 32 x 32 x 3 zoo trains on them. A seeded 80 / 20 split: train=True
    and train=False partition one permutation."""

    def __init__(self, path: str = "", train: bool = True, seed: int = 0,
                 image_size=(32, 32), split: float = 0.8):
        try:
            from sklearn.datasets import load_digits
        except ImportError as e:
            raise ImportError("DigitsDataLoader reads scikit-learn's "
                              "bundled digits; scikit-learn is not "
                              "installed") from e
        d = load_digits()
        imgs = (d.images * (255.0 / 16.0)).clip(0, 255).astype(np.uint8)
        imgs = _resize_bilinear(imgs[..., None].repeat(3, axis=-1),
                                image_size)
        data = imgs.astype(np.float32) / 255.0
        labels = d.target.astype(np.int32)
        order = np.random.default_rng(0).permutation(len(data))
        cut = int(len(data) * split)
        part = order[:cut] if train else order[cut:]
        self.num_classes = 10
        super().__init__(np.ascontiguousarray(data[part]), labels[part],
                         seed)


# -- Regression CSVs ----------------------------------------------------------


class RegressionCSVDataLoader(ArrayDataLoader):
    """A numeric CSV whose rows are ``features..., targets...``: the last
    ``num_targets`` columns are float32 targets. ``normalize`` standardizes
    the features by this split's statistics, or by ``stats`` (the train
    split's, for an eval split)."""

    def __init__(self, path: str, num_targets: int = 1,
                 normalize: bool = True,
                 stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 seed: int = 0):
        raw = np.loadtxt(path, delimiter=",", skiprows=_has_header(path),
                         dtype=np.float32)
        if raw.ndim == 1:
            raw = raw[None]
        if not 1 <= num_targets < raw.shape[1]:
            raise ValueError(f"{path}: num_targets must be in [1, "
                             f"{raw.shape[1] - 1}], got {num_targets}")
        feats, targets = raw[:, :-num_targets], raw[:, -num_targets:]
        if normalize:
            if stats is None:
                std = feats.std(0)
                std[std == 0] = 1.0
                stats = (feats.mean(0), std)
            feats = (feats - stats[0]) / stats[1]
        self.stats = stats
        super().__init__(np.ascontiguousarray(feats),
                         np.ascontiguousarray(targets), seed)
