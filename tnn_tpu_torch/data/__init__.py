"""Data loading (``tnn_tpu.data``): the loaders and their factory,
augmentation on the device, and the BPE tokenizer.

Reference parity targets: include/data_loading/ (loaders + factory),
include/data_augmentation/ (augmentation pipeline), include/tokenizer/ (GPT-2 decode).
"""
from .augmentation import (
    Augmentation,
    AugmentationBuilder,
    AugmentationPipeline,
    Brightness,
    Contrast,
    Cutout,
    GaussianNoise,
    HorizontalFlip,
    Normalization,
    RandomCrop,
    Rotation,
    VerticalFlip,
    cifar_train_pipeline,
)
from .datasets import (
    CIFAR10DataLoader,
    CIFAR100DataLoader,
    DigitsDataLoader,
    ImageFolderDataLoader,
    MNISTDataLoader,
    load_cifar10_bin,
    load_cifar100_bin,
    load_mnist_csv,
)
from .factory import available, create, register_loader
from .loader import (
    ArrayDataLoader,
    DataLoader,
    SyntheticDataLoader,
    prefetch,
    split_microbatches,
)
from .token_stream import OpenWebTextDataLoader, TokenStreamDataLoader
from .tokenizer import Tokenizer

__all__ = [
    "Augmentation", "AugmentationBuilder", "AugmentationPipeline", "Brightness",
    "Contrast", "Cutout", "GaussianNoise", "HorizontalFlip", "Normalization",
    "RandomCrop", "Rotation", "VerticalFlip", "cifar_train_pipeline",
    "CIFAR10DataLoader", "CIFAR100DataLoader", "DigitsDataLoader",
    "ImageFolderDataLoader",
    "MNISTDataLoader", "load_cifar10_bin", "load_cifar100_bin", "load_mnist_csv",
    "available", "create", "register_loader",
    "ArrayDataLoader", "DataLoader", "SyntheticDataLoader", "prefetch",
    "split_microbatches",
    "OpenWebTextDataLoader", "TokenStreamDataLoader", "Tokenizer",
]
