"""Model zoo (``tnn_tpu.models.zoo``): the GPT-2 entries of the port. The
"flash" variants select the flash-attention kernels (backend "pallas")."""
from __future__ import annotations

import functools
from typing import Sequence

from . import gpt2

_REGISTRY = {
    "gpt2_tiny": gpt2.gpt2_tiny,
    "gpt2_small": gpt2.gpt2_small,
    "gpt2_small_hd128": gpt2.gpt2_small_hd128,
    "gpt2_small_gqa4": gpt2.gpt2_small_gqa4,
    "gpt2_medium": gpt2.gpt2_medium,
    "gpt2_large": gpt2.gpt2_large,
}
_REGISTRY.update({
    f"flash_{name}": functools.partial(_REGISTRY[name], backend="pallas")
    for name in ("gpt2_small", "gpt2_small_hd128", "gpt2_small_gqa4",
                 "gpt2_medium", "gpt2_large")})


def create(name: str, **kw) -> gpt2.GPT2:
    """Instantiate a zoo model by name (``device=`` and ``seed=`` pass
    through to ``GPT2``)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)


def names() -> Sequence[str]:
    return sorted(_REGISTRY)
