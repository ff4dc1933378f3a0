"""The (io, param, compute) dtype policy triple of ``tnn_tpu.core.dtypes``.

``FP32`` computes everything in float32; ``MIXED_BF16`` (the default) runs
activations and matmuls in bfloat16 with float32 master parameters. As in
the JAX package, every layer keeps its parameters in ``param_dtype`` and
casts them to the compute dtype at each use (``cast_param``), so training
updates the float32 masters and the gradient flows back through the cast.
"""
from __future__ import annotations

import dataclasses

import torch

_NAME_TO_DTYPE = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    io: str = "bfloat16"
    param: str = "float32"
    compute: str = "bfloat16"

    def __post_init__(self):
        for f in ("io", "param", "compute"):
            if getattr(self, f) not in _NAME_TO_DTYPE:
                raise ValueError(f"unsupported {f} dtype {getattr(self, f)!r}")

    @property
    def io_dtype(self) -> torch.dtype:
        return _NAME_TO_DTYPE[self.io]

    @property
    def param_dtype(self) -> torch.dtype:
        return _NAME_TO_DTYPE[self.param]

    @property
    def compute_dtype(self) -> torch.dtype:
        return _NAME_TO_DTYPE[self.compute]

    def cast_in(self, x: torch.Tensor) -> torch.Tensor:
        """Cast a floating input to the compute dtype."""
        return x.to(self.compute_dtype) if x.is_floating_point() else x

    def cast_param(self, p: torch.Tensor) -> torch.Tensor:
        """Cast a (floating) parameter to the compute dtype at its use."""
        return p.to(self.compute_dtype) if p.is_floating_point() else p

    def cast_out(self, y: torch.Tensor) -> torch.Tensor:
        return y.to(self.io_dtype) if y.is_floating_point() else y


FP32 = DTypePolicy(io="float32", param="float32", compute="float32")
MIXED_BF16 = DTypePolicy(io="bfloat16", param="float32", compute="bfloat16")


def default_policy() -> DTypePolicy:
    """The policy a layer takes when none is given: MIXED_BF16."""
    return MIXED_BF16
