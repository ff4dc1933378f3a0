"""On-device data augmentation (``tnn_tpu.data.augmentation``): batch
transforms over NHWC tensors, run on the device inside the train step.

Every op is ``apply(generator, batch) -> batch`` and preserves the batch's
shape and dtype. Per-sample decisions are tensors drawn for the whole
batch at once and applied with ``torch.where``, so no decision reaches the
host. Draw order (``core.rng``): a pipeline runs its ops in order; an op
with probability ``p`` draws its (N,) gate first (a sample takes the op
where its uniform draw is below ``p``), then its own parameters, each a
draw for the whole batch. The JAX package splits one key per op and per
sample and draws other bits: a port op is held to the JAX op by what its
output must satisfy, and exactly where the op draws nothing or its draws
are fixed (``Normalization``, flips at p = 1 and p = 0,
``_bilinear_sample`` on given coordinates).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

_REGISTRY: Dict[str, Callable[..., "Augmentation"]] = {}


def register(name: str):
    def wrap(cls):
        _REGISTRY[name] = cls
        cls.type_name = name
        return cls
    return wrap


def from_config(cfg: Dict[str, Any]) -> "Augmentation":
    cfg = dict(cfg)
    return _REGISTRY[cfg.pop("type")](**cfg)


def _uniform(generator, n, low, high, device):
    """(n,) f32 uniform draws in [low, high)."""
    u = torch.rand(n, generator=generator, device=device)
    return low + (high - low) * u


def _randint(generator, n, high, device):
    """(n,) int64 draws in [0, high)."""
    return torch.randint(0, high, (n,), generator=generator, device=device)


class Augmentation:
    """One transform: ``apply(generator, batch)``, shape-preserving."""

    type_name = "augmentation"

    def apply(self, generator: torch.Generator,
              batch: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def get_config(self) -> Dict[str, Any]:
        return {"type": self.type_name, **{
            k: v for k, v in vars(self).items() if not k.startswith("_")}}


class _Gated(Augmentation):
    """An op taken per sample with probability ``p``: the gate is drawn,
    then ``_op`` (which draws its own parameters) runs on the whole batch
    and each sample keeps the result where its gate passed."""

    p: float = 0.5

    def apply(self, generator, batch):
        n = batch.shape[0]
        take = torch.rand(n, generator=generator, device=batch.device) \
            < self.p
        out = self._op(generator, batch)
        return torch.where(take.view((n,) + (1,) * (batch.ndim - 1)), out,
                           batch)

    def _op(self, generator, batch):
        raise NotImplementedError


@register("normalization")
class Normalization(Augmentation):
    """(batch - mean) / std per channel, mean and std in the batch's
    dtype."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = tuple(float(m) for m in mean)
        self.std = tuple(float(s) for s in std)

    def apply(self, generator, batch):
        mean = torch.tensor(self.mean, dtype=batch.dtype, device=batch.device)
        std = torch.tensor(self.std, dtype=batch.dtype, device=batch.device)
        return (batch - mean) / std


@register("horizontal_flip")
class HorizontalFlip(_Gated):
    def __init__(self, p: float = 0.5):
        self.p = p

    def _op(self, generator, batch):
        return batch.flip(2)


@register("vertical_flip")
class VerticalFlip(_Gated):
    def __init__(self, p: float = 0.5):
        self.p = p

    def _op(self, generator, batch):
        return batch.flip(1)


@register("brightness")
class Brightness(_Gated):
    """An additive shift in [-delta, delta) per sample, clipped to
    [0, 1]."""

    def __init__(self, delta: float = 0.2, p: float = 0.5):
        self.delta = delta
        self.p = p

    def _op(self, generator, batch):
        shift = _uniform(generator, batch.shape[0], -self.delta, self.delta,
                         batch.device).to(batch.dtype)
        return (batch + shift.view(-1, 1, 1, 1)).clamp(0.0, 1.0)


@register("contrast")
class Contrast(_Gated):
    """A factor in [lower, upper) per sample about each image's per-channel
    mean, clipped to [0, 1]."""

    def __init__(self, lower: float = 0.8, upper: float = 1.2,
                 p: float = 0.5):
        self.lower, self.upper, self.p = lower, upper, p

    def _op(self, generator, batch):
        factor = _uniform(generator, batch.shape[0], self.lower, self.upper,
                          batch.device).to(batch.dtype).view(-1, 1, 1, 1)
        mean = batch.mean(dim=(1, 2), keepdim=True)
        return ((batch - mean) * factor + mean).clamp(0.0, 1.0)


@register("gaussian_noise")
class GaussianNoise(_Gated):
    def __init__(self, stddev: float = 0.05, p: float = 0.5):
        self.stddev, self.p = stddev, p

    def _op(self, generator, batch):
        noise = torch.randn(batch.shape, generator=generator,
                            device=batch.device).to(batch.dtype)
        return (batch + self.stddev * noise).clamp(0.0, 1.0)


@register("random_crop")
class RandomCrop(_Gated):
    """Reflect-pad by ``padding``, then take an H x W window at a random
    (top, left) in [0, 2 * padding] per sample (the CIFAR recipe: pad 4,
    crop 32)."""

    def __init__(self, padding: int = 4, p: float = 1.0):
        self.padding, self.p = padding, p

    def _op(self, generator, batch):
        n, h, w, _ = batch.shape
        pad, dev = self.padding, batch.device
        padded = F.pad(batch.permute(0, 3, 1, 2), (pad,) * 4,
                       mode="reflect").permute(0, 2, 3, 1)
        top = _randint(generator, n, 2 * pad + 1, dev)
        left = _randint(generator, n, 2 * pad + 1, dev)
        rows = (top[:, None] + torch.arange(h, device=dev))[:, :, None]
        cols = (left[:, None] + torch.arange(w, device=dev))[:, None, :]
        return padded[torch.arange(n, device=dev)[:, None, None], rows, cols]


@register("cutout")
class Cutout(_Gated):
    """Zero a ``size`` x ``size`` square centred at a random pixel per
    sample (clipped at the borders)."""

    def __init__(self, size: int = 8, p: float = 0.5):
        self.size, self.p = size, p

    def _op(self, generator, batch):
        n, h, w, _ = batch.shape
        dev = batch.device
        y0 = (_randint(generator, n, h, dev) - self.size // 2).view(-1, 1, 1)
        x0 = (_randint(generator, n, w, dev) - self.size // 2).view(-1, 1, 1)
        ys = torch.arange(h, device=dev).view(1, -1, 1)
        xs = torch.arange(w, device=dev).view(1, 1, -1)
        inside = ((ys >= y0) & (ys < y0 + self.size)
                  & (xs >= x0) & (xs < x0 + self.size))
        return batch.masked_fill(inside[..., None], 0)


@register("rotation")
class Rotation(_Gated):
    """A rotation by an angle in [-max_degrees, max_degrees) per sample
    about the image centre, by bilinear resampling with edge clamping."""

    def __init__(self, max_degrees: float = 15.0, p: float = 0.5):
        self.max_degrees, self.p = max_degrees, p

    def _op(self, generator, batch):
        n, h, w, _ = batch.shape
        dev = batch.device
        theta = _uniform(generator, n, -1.0, 1.0, dev) \
            * (self.max_degrees * math.pi / 180.0)
        yc, xc = (h - 1) / 2.0, (w - 1) / 2.0
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                             device=dev),
                                torch.arange(w, dtype=torch.float32,
                                             device=dev), indexing="ij")
        cos = torch.cos(theta).view(-1, 1, 1)
        sin = torch.sin(theta).view(-1, 1, 1)
        # source coordinates: the inverse rotation
        sy = cos * (ys - yc) - sin * (xs - xc) + yc
        sx = sin * (ys - yc) + cos * (xs - xc) + xc
        return _bilinear_sample(batch, sy, sx)


def _bilinear_sample(img: torch.Tensor, sy: torch.Tensor,
                     sx: torch.Tensor) -> torch.Tensor:
    """Sample NHWC images at fractional (N, H', W') coordinates (sy, sx)
    with edge clamping, in f32, cast back to the images' dtype."""
    n, h, w, _ = img.shape
    y0 = torch.floor(sy).long().clamp(0, h - 1)
    x0 = torch.floor(sx).long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (sy - y0).clamp(0.0, 1.0)[..., None]
    wx = (sx - x0).clamp(0.0, 1.0)[..., None]
    b = torch.arange(n, device=img.device).view(-1, 1, 1)
    f = img.float()
    top = f[b, y0, x0] * (1 - wx) + f[b, y0, x1] * wx
    bot = f[b, y1, x0] * (1 - wx) + f[b, y1, x1] * wx
    return (top * (1 - wy) + bot * wy).to(img.dtype)


class AugmentationPipeline:
    """Ops applied in order (``apply``, which ``make_train_step(augment=
    ...)`` takes; calling the pipeline is the same)."""

    def __init__(self, ops: Sequence[Augmentation]):
        self.ops = list(ops)

    def apply(self, generator: torch.Generator,
              batch: torch.Tensor) -> torch.Tensor:
        for op in self.ops:
            batch = op.apply(generator, batch)
        return batch

    __call__ = apply

    def get_config(self) -> List[Dict[str, Any]]:
        return [op.get_config() for op in self.ops]

    @classmethod
    def from_config(cls, cfgs: Sequence[Dict[str, Any]]
                    ) -> "AugmentationPipeline":
        return cls([from_config(c) for c in cfgs])


class AugmentationBuilder:
    """A chained builder of a pipeline."""

    def __init__(self):
        self._ops: List[Augmentation] = []

    def add(self, op: Augmentation) -> "AugmentationBuilder":
        self._ops.append(op)
        return self

    def normalization(self, mean, std):
        return self.add(Normalization(mean, std))

    def horizontal_flip(self, p: float = 0.5):
        return self.add(HorizontalFlip(p))

    def vertical_flip(self, p: float = 0.5):
        return self.add(VerticalFlip(p))

    def brightness(self, delta: float = 0.2, p: float = 0.5):
        return self.add(Brightness(delta, p))

    def contrast(self, lower: float = 0.8, upper: float = 1.2,
                 p: float = 0.5):
        return self.add(Contrast(lower, upper, p))

    def gaussian_noise(self, stddev: float = 0.05, p: float = 0.5):
        return self.add(GaussianNoise(stddev, p))

    def random_crop(self, padding: int = 4, p: float = 1.0):
        return self.add(RandomCrop(padding, p))

    def cutout(self, size: int = 8, p: float = 0.5):
        return self.add(Cutout(size, p))

    def rotation(self, max_degrees: float = 15.0, p: float = 0.5):
        return self.add(Rotation(max_degrees, p))

    def build(self) -> AugmentationPipeline:
        return AugmentationPipeline(self._ops)


def cifar_train_pipeline(mean=(0.4914, 0.4822, 0.4465),
                         std=(0.247, 0.243, 0.261)) -> AugmentationPipeline:
    """The standard CIFAR recipe: crop + flip + cutout + normalize."""
    return (AugmentationBuilder()
            .random_crop(4)
            .horizontal_flip(0.5)
            .cutout(8, p=0.5)
            .normalization(mean, std)
            .build())
