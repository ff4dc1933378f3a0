"""The models (``tnn_tpu.models``): GPT-2, Llama, the ResNet / WRN / ViT
zoo and greedy generation. The names load at first use: ``core.module``
imports ``models.params`` while the models import the layers."""
import importlib

_EXPORTS = {"gpt2": None, "llama": None, "resnet": None, "vit": None,
            "zoo": None, "GPT2": "gpt2", "generate": "gpt2",
            "Llama": "llama", "ViT": "vit", "create": "zoo", "names": "zoo"}

__all__ = ["gpt2", "llama", "resnet", "vit", "zoo", "GPT2", "Llama",
           "generate", "ViT", "create", "names"]


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    home = _EXPORTS[name]
    value = importlib.import_module(f".{name}", __name__) if home is None \
        else getattr(importlib.import_module(f".{home}", __name__), name)
    globals()[name] = value
    return value
