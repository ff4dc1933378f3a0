"""Model zoo (``tnn_tpu.models.zoo``): the vision and language entries of
the JAX package's, by the same names. The "flash" variants select the
flash-attention kernels (backend "pallas"); ``moe_gpt2_small`` is
gpt2_small with an 8-expert top-2 MoE in every block.

A vision entry is sized at construction for per-sample inputs of
``input_shape`` (H, W, C), by default its dataset's (28 x 28 x 1 MNIST,
32 x 32 x 3 CIFAR and the digits set, 64 x 64 x 3 TinyImageNet, 224 x 224
x 3 ImageNet); ``device=`` and ``seed=`` pass through to every entry."""
from __future__ import annotations

import functools
from typing import Sequence

from torch import nn

from . import gpt2, llama, resnet, vit

_partial = functools.partial
_TINY = (64, 64, 3)

_VISION = {
    "mnist_cnn": _partial(resnet.mnist_cnn, num_classes=10),
    "cifar10_vgg": _partial(resnet.vgg11, num_classes=10),
    "cifar10_resnet9": _partial(resnet.resnet9, num_classes=10),
    "cifar100_resnet18": _partial(resnet.resnet18, num_classes=100),
    "cifar100_wrn16_8": _partial(resnet.wrn16_8, num_classes=100),
    # the 10-class WRN-16-8 of the bundled handwritten-digits set
    # (data.datasets.DigitsDataLoader)
    "digits_wrn16_8": _partial(resnet.wrn16_8, num_classes=10),
    "tiny_imagenet_resnet18": _partial(resnet.resnet18, num_classes=200,
                                       input_shape=_TINY),
    "tiny_imagenet_wrn16_8": _partial(resnet.wrn16_8, num_classes=200,
                                      input_shape=_TINY),
    "tiny_imagenet_resnet50": _partial(resnet.resnet50, num_classes=200,
                                       small_input=True, input_shape=_TINY),
    "resnet50_imagenet": _partial(resnet.resnet50, num_classes=1000,
                                  small_input=False),
}


def _vit(backend="xla", *, input_shape=_TINY, device="cuda", seed=0,
         **kw):
    return vit.ViT(num_classes=200, patch_size=8, backend=backend,
                   **kw).init(input_shape, device=device, seed=seed)


_VISION["tiny_imagenet_vit"] = _vit
_VISION["flash_vit"] = _partial(_vit, backend="pallas")

_REGISTRY = {
    **_VISION,
    "gpt2_tiny": gpt2.gpt2_tiny,
    "gpt2_small": gpt2.gpt2_small,
    "gpt2_small_hd128": gpt2.gpt2_small_hd128,
    "gpt2_small_gqa4": gpt2.gpt2_small_gqa4,
    "gpt2_medium": gpt2.gpt2_medium,
    "gpt2_large": gpt2.gpt2_large,
    "moe_gpt2_small": _partial(gpt2.gpt2_small, moe_experts=8),
    "llama_small": llama.llama_small,
    "llama_1b": llama.llama_1b,
}
_REGISTRY.update({
    f"flash_{name}": _partial(_REGISTRY[name], backend="pallas")
    for name in ("gpt2_small", "gpt2_small_hd128", "gpt2_small_gqa4",
                 "gpt2_medium", "gpt2_large", "llama_small")})


def create(name: str, **kw) -> nn.Module:
    """Instantiate a zoo model by name (``device=`` and ``seed=`` pass
    through; ``input_shape=`` and ``policy=`` to a vision entry)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)


def names() -> Sequence[str]:
    return sorted(_REGISTRY)


def vision_names() -> Sequence[str]:
    """The entries sized from an ``input_shape``."""
    return sorted(_VISION)
