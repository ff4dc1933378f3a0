"""The chained, shape-tracking model DSL (``tnn_tpu.nn.builder``).

``LayerBuilder(input_shape)`` appends one configured layer per call and
keeps the running output ``shape`` (without the batch dim), so the
residual blocks get the incoming channel count and ``positional_embedding``
the sequence length; ``build()`` returns the ``Sequential``, unbuilt:
``init(input_shape, device=, seed=)`` sizes it. The method inventory and
every layer's config are the JAX builder's, so the two packages' builder
models have the same config and parameter tree. ``flash_attention`` and
``flash_gpt_block`` select the flash kernels (backend "pallas": K4
forward, K7 backward on the card).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..core import dtypes as dt
from . import layers as L
from .activations import Activation
from .attention import MultiHeadAttention
from .blocks import Residual, Sequential
from .conv_blocks import basic_block, bottleneck_block, wide_basic_block
from .embedding import ClassToken, Embedding, PositionalEmbedding
from .norms import BatchNorm, GroupNorm, LayerNorm, RMSNorm
from .transformer import EncoderBlock, GPTBlock


class LayerBuilder:
    """Chained builder; ``input_shape`` excludes the batch dim."""

    def __init__(self, input_shape: Sequence[int],
                 policy: Optional[dt.DTypePolicy] = None):
        self.policy = policy or dt.default_policy()
        self._shape: Tuple[int, ...] = (1,) + tuple(int(d)
                                                    for d in input_shape)
        self._layers = []

    def _add(self, layer):
        self._layers.append(layer)
        self._shape = layer.output_shape(self._shape)
        return self

    @property
    def shape(self) -> Tuple[int, ...]:
        """The current output shape (without the batch dim)."""
        return self._shape[1:]

    def build(self, name: Optional[str] = None) -> Sequential:
        return Sequential(self._layers, name=name, policy=self.policy)

    def dense(self, units, activation=None, use_bias=True):
        return self._add(L.Dense(None, units, use_bias=use_bias,
                                 activation=activation, policy=self.policy))

    def conv2d(self, filters, kernel_size=3, strides=1, padding="same",
               use_bias=True, activation=None, groups=1):
        return self._add(L.Conv2D(filters, kernel_size, strides=strides,
                                  padding=padding, use_bias=use_bias,
                                  activation=activation, groups=groups,
                                  policy=self.policy))

    def batchnorm(self, momentum=0.9, eps=1e-5):
        return self._add(BatchNorm(momentum=momentum, eps=eps,
                                   policy=self.policy))

    def layernorm(self, eps=1e-5):
        return self._add(LayerNorm(None, eps=eps, policy=self.policy))

    def groupnorm(self, groups=32, eps=1e-5):
        return self._add(GroupNorm(groups=groups, eps=eps,
                                   policy=self.policy))

    def rmsnorm(self, eps=1e-6):
        return self._add(RMSNorm(None, eps=eps, policy=self.policy))

    def maxpool(self, pool_size=2, strides=None, padding="valid"):
        return self._add(L.MaxPool2D(pool_size, strides, padding,
                                     policy=self.policy))

    def avgpool(self, pool_size=2, strides=None, padding="valid"):
        return self._add(L.AvgPool2D(pool_size, strides, padding,
                                     policy=self.policy))

    def global_avgpool(self):
        return self._add(L.GlobalAvgPool(policy=self.policy))

    def activation(self, fn="relu"):
        return self._add(Activation(fn, policy=self.policy))

    def dropout(self, rate=0.5):
        return self._add(L.Dropout(rate, policy=self.policy))

    def flatten(self):
        return self._add(L.Flatten(policy=self.policy))

    def reshape(self, shape):
        return self._add(L.Reshape(shape, policy=self.policy))

    def transpose(self, perm):
        return self._add(L.Transpose(perm, policy=self.policy))

    def slice(self, axis, start, length):
        return self._add(L.Slice(axis, start, length, policy=self.policy))

    def embedding(self, vocab_size, dim):
        return self._add(Embedding(vocab_size, dim, policy=self.policy,
                                   device=None))

    def positional_embedding(self, max_len=None):
        max_len = max_len or self._shape[-2]
        return self._add(PositionalEmbedding(max_len, policy=self.policy))

    def class_token(self):
        return self._add(ClassToken(policy=self.policy))

    def attention(self, num_heads, causal=False, dropout=0.0):
        """Full softmax attention ("xla" backend)."""
        return self._add(MultiHeadAttention(
            None, num_heads, causal=causal, dropout=dropout,
            policy=self.policy))

    def flash_attention(self, num_heads, causal=False, dropout=0.0):
        """Attention on the flash kernels (backend "pallas")."""
        return self._add(MultiHeadAttention(
            None, num_heads, causal=causal, dropout=dropout,
            backend="pallas", policy=self.policy))

    def residual(self, main: Sequence, shortcut: Optional[Sequence] = None,
                 activation=None):
        children = [Sequential(list(main), policy=self.policy)]
        if shortcut:
            children.append(Sequential(list(shortcut), policy=self.policy))
        return self._add(Residual(children, activation=activation,
                                  policy=self.policy))

    def basic_residual_block(self, filters, strides=1):
        return self._add(basic_block(filters, strides,
                                     in_filters=self._shape[-1],
                                     policy=self.policy))

    def wide_residual_block(self, filters, strides=1, dropout=0.0):
        return self._add(wide_basic_block(filters, strides,
                                          in_filters=self._shape[-1],
                                          dropout=dropout,
                                          policy=self.policy))

    def bottleneck_residual_block(self, filters, strides=1):
        return self._add(bottleneck_block(filters, strides,
                                          in_filters=self._shape[-1],
                                          policy=self.policy))

    def gpt_block(self, num_heads, mlp_ratio=4, dropout=0.0):
        return self._add(GPTBlock(None, num_heads, mlp_ratio=mlp_ratio,
                                  dropout=dropout, policy=self.policy))

    def flash_gpt_block(self, num_heads, mlp_ratio=4, dropout=0.0):
        """``gpt_block`` on the flash kernels (backend "pallas")."""
        return self._add(GPTBlock(None, num_heads, mlp_ratio=mlp_ratio,
                                  dropout=dropout, backend="pallas",
                                  policy=self.policy))

    def encoder_block(self, num_heads, mlp_ratio=4, dropout=0.0):
        return self._add(EncoderBlock(None, num_heads, mlp_ratio=mlp_ratio,
                                      dropout=dropout, policy=self.policy))

    def llama_block(self, num_heads, mlp_hidden, num_kv_heads=None,
                    rope_theta=10000.0, backend="xla"):
        """The Llama block: pre-RMSNorm, RoPE and GQA attention, a
        bias-free SwiGLU MLP."""
        from ..models.llama import LlamaBlock

        return self._add(LlamaBlock(None, num_heads, mlp_hidden,
                                    num_kv_heads=num_kv_heads,
                                    rope_theta=rope_theta, backend=backend,
                                    policy=self.policy))
