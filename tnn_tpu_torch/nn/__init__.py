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
    **{name: "schedulers" for name in (
        "CosineAnnealingLR", "CosineAnnealingWarmRestarts", "ExponentialLR",
        "LinearWarmup", "MultiStepLR", "NoOp", "ReduceLROnPlateau", "StepLR",
        "WarmupCosineAnnealing")},
    "quantize_for_decode": "quant",
    # the submodules themselves
    **{name: None for name in (
        "activations", "attention", "blocks", "embedding", "initializers",
        "layers", "losses", "metrics", "norms", "optimizers", "quant",
        "schedulers", "transformer")},
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    home = _EXPORTS[name]
    value = importlib.import_module(f".{name}", __name__) if home is None \
        else getattr(importlib.import_module(f".{home}", __name__), name)
    globals()[name] = value
    return value
