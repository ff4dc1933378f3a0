"""The loader factory (``tnn_tpu.data.factory``): a loader by dataset
name, with the JAX package's names."""
from __future__ import annotations

from typing import Callable, Dict

from .datasets import (CIFAR10DataLoader, CIFAR100DataLoader,
                       DigitsDataLoader, ImageFolderDataLoader,
                       MNISTDataLoader, RegressionCSVDataLoader)
from .loader import DataLoader, SyntheticDataLoader
from .token_stream import OpenWebTextDataLoader

_FACTORY: Dict[str, Callable[..., DataLoader]] = {}


def register_loader(name: str, fn: Callable[..., DataLoader]) -> None:
    _FACTORY[name] = fn


def create(name: str, path: str = "", **kw) -> DataLoader:
    """A loader by dataset name (``available()``); ``kw`` pass through."""
    if name not in _FACTORY:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(_FACTORY)}")
    return _FACTORY[name](path, **kw)


def available() -> list:
    return sorted(_FACTORY)


register_loader("mnist", MNISTDataLoader)
register_loader("digits", DigitsDataLoader)
register_loader("cifar10", CIFAR10DataLoader)
register_loader("cifar100", CIFAR100DataLoader)
register_loader("tiny_imagenet",
                lambda path, image_size=(64, 64), **kw:
                ImageFolderDataLoader(path, image_size=image_size, **kw))
register_loader("imagenet100",
                lambda path, image_size=(224, 224), **kw:
                ImageFolderDataLoader(path, image_size=image_size, **kw))
register_loader("openwebtext", OpenWebTextDataLoader)
register_loader("synthetic_cifar",
                lambda path, num_samples=2048, num_classes=100, **kw:
                SyntheticDataLoader(num_samples, (32, 32, 3), num_classes,
                                    **kw))
register_loader("synthetic_mnist",
                lambda path, num_samples=2048, **kw:
                SyntheticDataLoader(num_samples, (28, 28, 1), 10, **kw))
register_loader("regression_csv", RegressionCSVDataLoader)
