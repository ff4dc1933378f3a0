"""The port's layers, blocks, graph and builder DSL (``tnn_tpu.nn``).

The names load lazily: the layer modules import ``core.module``, which
itself imports from this package.
"""
import importlib

_EXPORTS = {
    "Activation": "activations", "MultiHeadAttention": "attention",
    "sdpa": "attention", "ring_context": "attention",
    "set_attention_backend": "attention", "Parallel": "blocks", "Residual": "blocks",
    "Sequential": "blocks", "LayerBuilder": "builder",
    "ClassToken": "embedding", "Embedding": "embedding",
    "PositionalEmbedding": "embedding", "Add": "graph", "Concat": "graph",
    "Graph": "graph", "GraphNode": "graph", "AvgPool2D": "layers",
    "Conv2D": "layers", "Dense": "layers", "Dropout": "layers",
    "Flatten": "layers", "GlobalAvgPool": "layers", "Identity": "layers",
    "MaxPool2D": "layers", "Reshape": "layers", "Slice": "layers",
    "Transpose": "layers", "MoE": "moe", "BatchNorm": "norms",
    "GroupNorm": "norms", "LayerNorm": "norms", "RMSNorm": "norms",
    "SGD": "optimizers", "Adam": "optimizers", "AdamW": "optimizers",
    "EncoderBlock": "transformer", "GPTBlock": "transformer",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                    name)
    globals()[name] = value
    return value
