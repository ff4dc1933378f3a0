"""The loader base of ``tnn_tpu.data.loader``: host-side numpy batches,
drawn from the loader's own seeded ``np.random.Generator``."""
from __future__ import annotations

from typing import Tuple

import numpy as np


class DataLoader:
    """Subclasses implement ``_get(indices) -> (data, labels)`` over sample
    indices and set ``_num_samples``."""

    def __init__(self, seed: int = 0):
        self._num_samples = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._num_samples

    def _get(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError
