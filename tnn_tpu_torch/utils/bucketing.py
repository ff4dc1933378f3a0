"""Power-of-two bucketing of step widths (``tnn_tpu.utils.bucketing``)."""
from __future__ import annotations

from typing import Optional


def pow2_bucket(n: int, cap: Optional[int] = None) -> int:
    """Smallest power of two >= ``n``, clamped to ``cap`` when given.

    ``pow2_bucket(5) == 8``; ``pow2_bucket(5, cap=6) == 6``.
    """
    if n < 1:
        raise ValueError(f"pow2_bucket needs n >= 1, got {n}")
    bucket = 1 << (n - 1).bit_length()
    if cap is not None:
        bucket = min(bucket, cap)
    return bucket
