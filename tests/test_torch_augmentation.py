"""Port parity: on-device augmentation (``tnn_tpu_torch.data.
augmentation``) against the JAX package's.

The ops that draw nothing, or whose draws are fixed, are held exactly:
``Normalization``, the flips at p = 1 and p = 0, and ``_bilinear_sample``
on the same coordinates. The random ops draw other bits than JAX's and are
held by what their output must satisfy: a ``RandomCrop`` output is a window
of the reflect-padded input, ``Cutout`` zeroes exactly one clipped square,
a ``Brightness`` shift is one constant per image, and p = 0 is the
identity. The pipeline runs inside ``make_train_step`` on the batch and
draws from the state's generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnn_tpu.data import augmentation as jaug
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.data import augmentation as taug
from tnn_tpu_torch.models import resnet
from tnn_tpu_torch.nn.optimizers import SGD
from tnn_tpu_torch.train import create_train_state, make_train_step


def _batch(seed=0, shape=(4, 8, 10, 3)):
    # no zeros, so a zeroed pixel is one Cutout zeroed
    return np.random.default_rng(seed).random(shape, dtype=np.float32) + 0.01


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("op", ["normalization", "hflip1", "hflip0",
                                "vflip1", "vflip0"])
def test_deterministic_ops_exact(op):
    x = _batch(1)
    make = {"normalization": lambda m: m.Normalization((0.4, 0.5, 0.6),
                                                       (0.2, 0.25, 0.3)),
            "hflip1": lambda m: m.HorizontalFlip(1.0),
            "hflip0": lambda m: m.HorizontalFlip(0.0),
            "vflip1": lambda m: m.VerticalFlip(1.0),
            "vflip0": lambda m: m.VerticalFlip(0.0)}[op]
    ref = make(jaug).apply(jax.random.PRNGKey(0), jnp.asarray(x))
    out = make(taug).apply(_gen(), torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert make(taug).get_config() == make(jaug).get_config()


def test_bilinear_sample_on_same_coordinates():
    """In-range, fractional and out-of-range (clamped) coordinates."""
    img = _batch(2, (1, 6, 7, 3))[0]
    rng = np.random.default_rng(3)
    sy = rng.uniform(-1.5, 7.5, (5, 9)).astype(np.float32)
    sx = rng.uniform(-1.5, 8.5, (5, 9)).astype(np.float32)
    ref = jaug._bilinear_sample(jnp.asarray(img), jnp.asarray(sy),
                                jnp.asarray(sx))
    out = taug._bilinear_sample(torch.from_numpy(img)[None],
                                torch.from_numpy(sy)[None],
                                torch.from_numpy(sx)[None])[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_random_crop_is_a_window_of_the_padded_input():
    x = _batch(4)
    pad = 2
    out = taug.RandomCrop(pad).apply(_gen(5), torch.from_numpy(x)).numpy()
    padded = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                    mode="reflect")
    h, w = x.shape[1:3]
    offsets = set()
    for i in range(len(x)):
        hits = [(t, l) for t in range(2 * pad + 1) for l in range(2 * pad + 1)
                if np.array_equal(padded[i, t:t + h, l:l + w], out[i])]
        assert hits, f"sample {i} is no window of its padded image"
        offsets.add(hits[0])
    assert len(offsets) > 1           # the draw varies across the batch


def test_cutout_zeroes_one_clipped_square():
    x = _batch(6, (16, 12, 12, 3))
    size = 4
    out = taug.Cutout(size, p=1.0).apply(_gen(7), torch.from_numpy(x)).numpy()
    for i in range(len(x)):
        zero = (out[i] == 0).all(-1)
        assert np.array_equal(out[i][~zero], x[i][~zero])
        ys, xs = np.nonzero(zero)
        assert len(ys), "nothing cut"
        y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
        assert zero[y0:y1, x0:x1].all() and zero.sum() == (y1 - y0) * (x1 - x0)
        assert y1 - y0 <= size and x1 - x0 <= size
        # a square smaller than size only where it meets a border
        assert y1 - y0 == size or y0 == 0 or y1 == 12
        assert x1 - x0 == size or x0 == 0 or x1 == 12


def test_random_ops_invariants():
    x = torch.from_numpy(_batch(8))
    shifted = taug.Brightness(0.2, p=1.0).apply(_gen(9), x)
    inner = (shifted > 0) & (shifted < 1)
    for i in range(len(x)):
        d = (shifted[i] - x[i])[inner[i]]
        assert float(d.max() - d.min()) < 1e-6 and abs(float(d[0])) <= 0.2
    for op in (taug.Brightness(p=0.0), taug.Contrast(p=0.0),
               taug.GaussianNoise(p=0.0), taug.Cutout(p=0.0),
               taug.Rotation(p=0.0), taug.RandomCrop(p=0.0)):
        assert torch.equal(op.apply(_gen(), x), x), op.type_name
    for op in (taug.Contrast(p=1.0), taug.GaussianNoise(0.3, p=1.0)):
        y = op.apply(_gen(10), x)
        assert float(y.min()) >= 0.0 and float(y.max()) <= 1.0
    # a zero-degree rotation resamples every pixel at its own coordinates
    assert torch.equal(taug.Rotation(0.0, p=1.0).apply(_gen(), x), x)
    ys = taug.Rotation(30.0, p=1.0).apply(_gen(11), x)
    assert ys.shape == x.shape and not torch.equal(ys, x)


def test_pipeline_config_and_draws():
    pipe = taug.cifar_train_pipeline()
    ref = jaug.cifar_train_pipeline()
    assert pipe.get_config() == ref.get_config()
    again = taug.AugmentationPipeline.from_config(pipe.get_config())
    assert again.get_config() == pipe.get_config()
    x = torch.from_numpy(_batch(12, (4, 32, 32, 3)))
    a, b = pipe.apply(_gen(13), x), again(_gen(13), x)
    assert torch.equal(a, b)          # the same generator, the same draws
    assert not torch.equal(a, pipe.apply(_gen(14), x))
    built = (taug.AugmentationBuilder().brightness().contrast()
             .gaussian_noise().rotation().vertical_flip().build())
    assert [op.type_name for op in built.ops] == [
        "brightness", "contrast", "gaussian_noise", "rotation",
        "vertical_flip"]


def test_train_step_runs_the_pipeline_on_the_state_generator():
    """``make_train_step(augment=...)`` augments the batch on its device
    before the forward, drawing from ``state.generator``: two runs from one
    seed agree, and the step with augmentation differs from the one
    without."""
    x = torch.from_numpy(_batch(15, (4, 16, 16, 3)))
    y = torch.arange(4) % 10

    def run(augment, seed=0):
        model = resnet.wrn(depth=10, widen=1, num_classes=10,
                           policy=tdt.FP32, input_shape=(16, 16, 3),
                           device="cpu", seed=0)
        opt = SGD(lr=0.1)
        state = create_train_state(model, opt, seed=seed)
        step = make_train_step(model, opt, augment=augment)
        _, m = step(state, x, y)
        return float(m["loss"])

    pipe = taug.cifar_train_pipeline().apply
    assert run(pipe) == run(pipe)
    assert run(pipe) != run(None)
    assert run(pipe, seed=1) != run(pipe, seed=0)
