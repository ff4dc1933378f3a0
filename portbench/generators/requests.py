"""Generation requests for a serving mix: lengths, arrivals and token ids.

A mix file gives, besides its driver:

- ``prompt_len``: {"dist": "lognormal", "median", "sigma", "min", "max"}
  or {"dist": "uniform", "min", "max"} (whole tokens, both ends kept);
- ``output_len``: the same forms (every request decodes exactly this
  many tokens: no stop token);
- ``arrivals``: {"kind": "closed", "clients": N} (each client sends its
  next request when its last one ends) or {"kind": "poisson", "rate": r}
  (requests a second, independent of the system);
- ``shape_seed``, ``block`` and ``pool``: the sizes, and an open mix's
  arrival times, are drawn once from ``shape_seed``, so every run seed
  serves the same sizes at the same times. The run's seed shuffles the
  sizes within each run of ``block`` requests, so that every whole number
  of blocks from the start holds the same sizes on every seed (``block``
  1 keeps the drawn order), and draws the token ids (uniform over the
  vocabulary, nothing shared). A closed
  mix draws ``pool`` requests; an open one as many as its gaps fit into
  the window.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class Request:
    prompt: np.ndarray            # int32 token ids
    out_len: int
    at: Optional[float] = None    # seconds after the window opens (open)


def _lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        x = rng.lognormal(np.log(float(spec["median"])), float(spec["sigma"]),
                          n)
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    if spec["dist"] == "uniform":
        return rng.integers(lo, hi + 1, n)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def arrival_gaps(mix: dict, seconds: float) -> np.ndarray:
    """The open mix's gaps between arrivals, drawn from ``shape_seed``:
    as many as fit, summed, into ``seconds``."""
    rate = float(mix["arrivals"]["rate"])
    rng = np.random.default_rng([int(mix["shape_seed"]), 1])
    n = int(rate * seconds * 2) + 16
    gaps = rng.exponential(1.0 / rate, n)
    keep = np.cumsum(gaps) <= seconds
    return gaps[keep]


def block_order(n: int, block: int, rng: np.random.Generator
                ) -> np.ndarray:
    """A permutation of ``range(n)`` that shuffles each run of ``block``
    positions within itself."""
    idx = np.arange(n)
    for at in range(0, n, block):
        rng.shuffle(idx[at:at + block])
    return idx


def plan(mix: dict, seed: int, seconds: float, vocab: int
         ) -> List[Request]:
    """The run's requests in sending order."""
    arrivals = mix["arrivals"]
    if arrivals["kind"] == "closed":
        gaps = None
        n = int(mix["pool"])
    elif arrivals["kind"] == "poisson":
        gaps = arrival_gaps(mix, seconds)
        n = len(gaps)
    else:
        raise ValueError(f"unknown arrivals {arrivals['kind']!r}")
    shape = np.random.default_rng([int(mix["shape_seed"]), 0])
    p_len = _lengths(mix["prompt_len"], n, shape)
    o_len = _lengths(mix["output_len"], n, shape)
    rng = np.random.default_rng(int(seed) % (1 << 63))
    block = int(mix["block"])
    order = block_order(n, block, rng)
    p_len, o_len = p_len[order], o_len[order]
    at = None if gaps is None else np.cumsum(gaps)
    ids = rng.integers(0, vocab, int(p_len.sum()), dtype=np.int32)
    cuts = np.cumsum(p_len)[:-1]
    return [Request(prompt=p, out_len=int(o),
                    at=None if at is None else float(at[i]))
            for i, (p, o) in enumerate(zip(np.split(ids, cuts), o_len))]
