"""Memory-mapped token-stream loader for LM training
(``tnn_tpu.data.token_stream``): (B, S) windows over a flat token file,
with the shifted next-token labels as int32 ids, and the OpenWebText
loader over a uint16 file. Windows are read on the native runtime's
threads where it is built (``native.api.TokenFile`` over the same file:
the same windows), from a numpy memmap otherwise."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .loader import DataLoader


class TokenStreamDataLoader(DataLoader):
    """(B, S) windows over a flat token file, with shifted labels."""

    def __init__(self, path: str, context_length: int, dtype=np.uint16,
                 seed: int = 0, pad_token_id: Optional[int] = None):
        from .. import native

        super().__init__(seed)
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        # dtypes the native reader does not take keep the numpy path
        self._native_tokens = None
        if np.dtype(dtype) in (np.uint16, np.int32, np.uint32) \
                and native.available():
            try:
                self._native_tokens = native.api.TokenFile(path, dtype)
            except (ValueError, OSError):
                self._native_tokens = None
        self.context_length = int(context_length)
        self.pad_token_id = pad_token_id
        # valid starts are 0..L-S-1: S tokens plus one label lookahead
        self._num_samples = max(0, len(self.tokens) - self.context_length)
        self._data_shape = (self.context_length,)
        self._label_shape = (self.context_length,)

    def _get(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        s = self.context_length
        if self._native_tokens is not None:
            full = self._native_tokens.windows(
                np.asarray(indices, np.int64), s + 1)
            # data and labels are overlapping views of ``full``: masking
            # the labels in place would reach the data
            data, labels = full[:, :-1], full[:, 1:]
            if self.pad_token_id is not None:
                labels = labels.copy()
        else:
            data = np.empty((len(indices), s), np.int32)
            labels = np.empty((len(indices), s), np.int32)
            for b, start in enumerate(indices):
                window = np.asarray(self.tokens[start:start + s + 1],
                                    np.int32)
                data[b] = window[:-1]
                labels[b] = window[1:]
        if self.pad_token_id is not None:
            labels[labels == self.pad_token_id] = -1   # ignored by the loss
        return data, labels

    def random_windows(self, batch_size: int,
                       rng: Optional[np.random.Generator] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """``batch_size`` uniformly random windows, drawn from ``rng`` (the
        loader's own when None)."""
        if self._num_samples == 0:
            raise ValueError(
                f"token file has {len(self.tokens)} tokens — too short for "
                f"context_length={self.context_length} (need at least "
                f"{self.context_length + 1})")
        rng = rng or self._rng
        starts = rng.integers(0, self._num_samples, batch_size)
        return self._get(starts)


class OpenWebTextDataLoader(TokenStreamDataLoader):
    """A uint16 token file such as OpenWebText's GPT-2-encoded ``.bin``."""

    def __init__(self, path: str, context_length: int = 1024, seed: int = 0):
        super().__init__(path, context_length, dtype=np.uint16, seed=seed)
