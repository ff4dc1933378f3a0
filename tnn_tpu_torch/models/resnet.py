"""ResNet / WideResNet / VGG builders (``tnn_tpu.models.resnet``),
composed from the container blocks, NHWC.

Each builder takes, beside the JAX builder's arguments, the per-sample
``input_shape`` (H, W, C) its widths come from, the ``device`` ("cuda"
by default) and the ``seed`` of its weights (None leaves them zero, for a
file's weights to fill): the JAX package sizes a model at ``init``, the
port at construction.
"""
from __future__ import annotations

from ..nn.activations import Activation
from ..nn.blocks import Sequential
from ..nn.conv_blocks import (basic_block, bottleneck_block, conv_bn,
                              wide_basic_block)
from ..nn.layers import Conv2D, Dense, Dropout, Flatten, GlobalAvgPool, \
    MaxPool2D
from ..nn.norms import BatchNorm


def _dense(units, activation=None, policy=None):
    return Dense(None, units, activation=activation, policy=policy)


def _built(model, input_shape, device, seed):
    return model.init(input_shape, device=device, seed=seed)


def mnist_cnn(num_classes: int = 10, policy=None, *, input_shape=(28, 28, 1),
              device="cuda", seed=0):
    p = policy
    model = Sequential(
        conv_bn(32, 3, 1, "relu", p) + [MaxPool2D(2, policy=p)]
        + conv_bn(64, 3, 1, "relu", p) + [MaxPool2D(2, policy=p)]
        + [Flatten(policy=p), _dense(128, "relu", p),
           Dropout(0.25, policy=p), _dense(num_classes, policy=p)],
        name="mnist_cnn", policy=p)
    return _built(model, input_shape, device, seed)


def vgg11(num_classes: int = 10, policy=None, *, input_shape=(32, 32, 3),
          device="cuda", seed=0):
    p = policy
    layers = []
    for v in [64, "M", 128, "M", 256, 256, "M", 512, 512, "M"]:
        if v == "M":
            layers.append(MaxPool2D(2, policy=p))
        else:
            layers += conv_bn(v, 3, 1, "relu", p)
    layers += [Flatten(policy=p), _dense(512, "relu", p),
               Dropout(0.5, policy=p), _dense(num_classes, policy=p)]
    return _built(Sequential(layers, name="vgg11", policy=p), input_shape,
                  device, seed)


def resnet9(num_classes: int = 10, policy=None, *, input_shape=(32, 32, 3),
            device="cuda", seed=0):
    p = policy
    model = Sequential(
        conv_bn(64, 3, 1, "relu", p)
        + conv_bn(128, 3, 1, "relu", p) + [MaxPool2D(2, policy=p)]
        + [basic_block(128, policy=p)]
        + conv_bn(256, 3, 1, "relu", p) + [MaxPool2D(2, policy=p)]
        + conv_bn(512, 3, 1, "relu", p) + [MaxPool2D(2, policy=p)]
        + [basic_block(512, policy=p)]
        + [MaxPool2D(4, policy=p), Flatten(policy=p),
           _dense(num_classes, policy=p)],
        name="resnet9", policy=p)
    return _built(model, input_shape, device, seed)


def _stem(small_input, p):
    if small_input:
        return conv_bn(64, 3, 1, "relu", p)
    return conv_bn(64, 7, 2, "relu", p) + [MaxPool2D(3, 2, padding="same",
                                                     policy=p)]


def resnet18(num_classes: int = 100, small_input: bool = True, policy=None,
             *, input_shape=(32, 32, 3), device="cuda", seed=0):
    """ResNet-18; ``small_input``: the CIFAR 3x3 stem (no 7x7 / 2 and no
    stem max pool)."""
    p = policy
    layers = _stem(small_input, p)
    in_f = 64
    for gi, w in enumerate([64, 128, 256, 512]):
        for bi in range(2):
            strides = 2 if (gi > 0 and bi == 0) else 1
            layers.append(basic_block(w, strides, in_filters=in_f, policy=p))
            in_f = w
    layers += [GlobalAvgPool(policy=p), _dense(num_classes, policy=p)]
    return _built(Sequential(layers, name="resnet18", policy=p), input_shape,
                  device, seed)


def resnet50(num_classes: int = 1000, small_input: bool = False,
             policy=None, *, input_shape=(224, 224, 3), device="cuda",
             seed=0):
    p = policy
    layers = _stem(small_input, p)
    in_f = 64
    for gi, (w, n) in enumerate(zip([64, 128, 256, 512], [3, 4, 6, 3])):
        for bi in range(n):
            strides = 2 if (gi > 0 and bi == 0) else 1
            layers.append(bottleneck_block(w, strides, in_filters=in_f,
                                           policy=p))
            in_f = w * 4
    layers += [GlobalAvgPool(policy=p), _dense(num_classes, policy=p)]
    return _built(Sequential(layers, name="resnet50", policy=p), input_shape,
                  device, seed)


def wrn16_8(num_classes: int = 100, dropout: float = 0.0, policy=None,
            **kw):
    """WideResNet-16-8: 2 blocks a group, widths [128, 256, 512], ~11M
    parameters."""
    return wrn(depth=16, widen=8, num_classes=num_classes, dropout=dropout,
               policy=policy, **kw)


def wrn(depth: int = 16, widen: int = 8, num_classes: int = 100,
        dropout: float = 0.0, policy=None, *, input_shape=(32, 32, 3),
        device="cuda", seed=0):
    p = policy
    if (depth - 4) % 6:
        raise ValueError(f"WRN depth must be 6n+4, got {depth}")
    n = (depth - 4) // 6
    layers = [Conv2D(16, 3, padding="same", use_bias=False, policy=p)]
    in_f = 16
    for gi, w in enumerate([16 * widen, 32 * widen, 64 * widen]):
        for bi in range(n):
            strides = 2 if (gi > 0 and bi == 0) else 1
            layers.append(wide_basic_block(w, strides, in_filters=in_f,
                                           dropout=dropout, policy=p))
            in_f = w
    layers += [BatchNorm(policy=p), Activation("relu", policy=p),
               GlobalAvgPool(policy=p), _dense(num_classes, policy=p)]
    return _built(Sequential(layers, name=f"wrn{depth}_{widen}", policy=p),
                  input_shape, device, seed)
