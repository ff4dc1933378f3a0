"""Model zoo (``tnn_tpu.models.zoo``): the GPT-2 and Llama entries of the
port. The "flash" variants select the flash-attention kernels (backend
"pallas"); ``moe_gpt2_small`` is gpt2_small with an 8-expert top-2 MoE in
every block."""
from __future__ import annotations

import functools
from typing import Sequence

from torch import nn

from . import gpt2, llama

_REGISTRY = {
    "gpt2_tiny": gpt2.gpt2_tiny,
    "gpt2_small": gpt2.gpt2_small,
    "gpt2_small_hd128": gpt2.gpt2_small_hd128,
    "gpt2_small_gqa4": gpt2.gpt2_small_gqa4,
    "gpt2_medium": gpt2.gpt2_medium,
    "gpt2_large": gpt2.gpt2_large,
    "moe_gpt2_small": functools.partial(gpt2.gpt2_small, moe_experts=8),
    "llama_small": llama.llama_small,
    "llama_1b": llama.llama_1b,
}
_REGISTRY.update({
    f"flash_{name}": functools.partial(_REGISTRY[name], backend="pallas")
    for name in ("gpt2_small", "gpt2_small_hd128", "gpt2_small_gqa4",
                 "gpt2_medium", "gpt2_large", "llama_small")})


def create(name: str, **kw) -> nn.Module:
    """Instantiate a zoo model by name (``device=`` and ``seed=`` pass
    through to ``GPT2`` or ``Llama``)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)


def names() -> Sequence[str]:
    return sorted(_REGISTRY)
