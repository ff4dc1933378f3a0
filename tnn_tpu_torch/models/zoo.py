"""Model zoo (``tnn_tpu.models.zoo``): the GPT-2 entries the port serves."""
from __future__ import annotations

from typing import Sequence

from . import gpt2

_REGISTRY = {
    "gpt2_tiny": gpt2.gpt2_tiny,
    "gpt2_small": gpt2.gpt2_small,
    "gpt2_small_hd128": gpt2.gpt2_small_hd128,
    "gpt2_small_gqa4": gpt2.gpt2_small_gqa4,
}


def create(name: str, **kw) -> gpt2.GPT2:
    """Instantiate a zoo model by name (``device=`` and ``seed=`` pass
    through to ``GPT2``)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)


def names() -> Sequence[str]:
    return sorted(_REGISTRY)
