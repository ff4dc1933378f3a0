"""Convolutional residual-block combinators (``tnn_tpu.nn.conv_blocks``):
conv + BatchNorm, and the basic, bottleneck and wide residual blocks."""
from __future__ import annotations

from .activations import Activation
from .blocks import Residual, Sequential
from .layers import Conv2D, Dropout
from .norms import BatchNorm


def conv_bn(filters, kernel=3, strides=1, activation="relu", policy=None):
    layers = [Conv2D(filters, kernel, strides=strides, padding="same",
                     use_bias=False, policy=policy),
              BatchNorm(policy=policy)]
    if activation:
        layers.append(Activation(activation, policy=policy))
    return layers


def basic_block(filters, strides=1, in_filters=None, policy=None):
    """The post-activation basic residual block."""
    main = Sequential(conv_bn(filters, 3, strides, "relu", policy)
                      + conv_bn(filters, 3, 1, None, policy), policy=policy)
    children = [main]
    if strides != 1 or (in_filters is not None and in_filters != filters):
        children.append(Sequential(conv_bn(filters, 1, strides, None,
                                           policy), policy=policy))
    return Residual(children, activation="relu", policy=policy)


def bottleneck_block(filters, strides=1, in_filters=None, expansion=4,
                     policy=None):
    """The 1x1 -> 3x3 -> 1x1 bottleneck block."""
    out_filters = filters * expansion
    main = Sequential(conv_bn(filters, 1, 1, "relu", policy)
                      + conv_bn(filters, 3, strides, "relu", policy)
                      + conv_bn(out_filters, 1, 1, None, policy),
                      policy=policy)
    children = [main]
    if strides != 1 or (in_filters is not None
                        and in_filters != out_filters):
        children.append(Sequential(conv_bn(out_filters, 1, strides, None,
                                           policy), policy=policy))
    return Residual(children, activation="relu", policy=policy)


def wide_basic_block(filters, strides=1, in_filters=None, dropout=0.0,
                     policy=None):
    """The pre-activation wide block (WRN-16-8)."""
    layers = [BatchNorm(policy=policy), Activation("relu", policy=policy),
              Conv2D(filters, 3, strides=strides, padding="same",
                     use_bias=False, policy=policy),
              BatchNorm(policy=policy), Activation("relu", policy=policy)]
    if dropout > 0:
        layers.append(Dropout(dropout, policy=policy))
    layers.append(Conv2D(filters, 3, padding="same", use_bias=False,
                         policy=policy))
    children = [Sequential(layers, policy=policy)]
    if strides != 1 or (in_filters is not None and in_filters != filters):
        children.append(Conv2D(filters, 1, strides=strides, padding="same",
                               use_bias=False, policy=policy))
    return Residual(children, policy=policy)
