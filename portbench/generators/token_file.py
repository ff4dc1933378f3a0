"""A seeded token file for language-model training: ``tokens`` ids,
uniform over the vocabulary, as a flat uint16 file (the layout of a
GPT-2-encoded OpenWebText ``.bin``), written from the run's seed."""
from __future__ import annotations

from pathlib import Path

import numpy as np

CHUNK = 1 << 22


def write(path: Path, tokens: int, vocab: int, seed: int) -> Path:
    if vocab > 1 << 16:
        raise ValueError(f"vocab {vocab} does not fit uint16 ids")
    rng = np.random.default_rng([int(seed) % (1 << 63), 2])
    with open(path, "wb") as f:
        for at in range(0, tokens, CHUNK):
            n = min(CHUNK, tokens - at)
            rng.integers(0, vocab, n, dtype=np.uint16).tofile(f)
    return path


def windows(path: Path, starts, seq: int):
    """(data, labels) int64 arrays of the windows at ``starts``: ``seq``
    tokens and the ``seq`` that follow each by one, read from the raw
    file."""
    toks = np.memmap(path, dtype=np.uint16, mode="r")
    full = np.stack([np.asarray(toks[s:s + seq + 1], np.int64)
                     for s in starts])
    return full[:, :-1], full[:, 1:]
