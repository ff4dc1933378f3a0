"""Data loaders (``tnn_tpu.data.loader``): host-side numpy batches drawn
in the loader's order, and the producer thread that stages them on the
device.

``DataLoader`` keeps a cursor and, once ``shuffle()`` was called, a
permutation drawn from its own seeded ``np.random.Generator`` (redrawn at
each ``reset``). ``state_dict`` holds the cursor and the generator's state
before and after the last draw, not the permutation: ``load_state_dict``
redraws the same order, so a restored loader goes on where the saved one
stopped. The JAX package's loaders give the same orders from the same seed
(both draw with numpy). ``prefetch`` overlaps batch assembly and the
host-to-device copy with the step: a producer thread, pinned host tensors
and a ``non_blocking`` copy.
"""
from __future__ import annotations

import functools
import queue
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch


class DataLoader:
    """Subclasses implement ``_get(indices) -> (data, labels)`` over sample
    indices and set ``_num_samples``, ``_data_shape`` and
    ``_label_shape``."""

    def __init__(self, seed: int = 0):
        self._num_samples = 0
        self._data_shape: Tuple[int, ...] = ()
        self._label_shape: Tuple[int, ...] = ()
        self._rng = np.random.default_rng(seed)
        self._order: Optional[np.ndarray] = None
        self._cursor = 0
        self._shuffled = False

    def __len__(self) -> int:
        return self._num_samples

    @property
    def num_samples(self) -> int:
        return self._num_samples

    @property
    def data_shape(self) -> Tuple[int, ...]:
        """Per-sample shape."""
        return self._data_shape

    @property
    def label_shape(self) -> Tuple[int, ...]:
        return self._label_shape

    def shuffle(self) -> None:
        self._shuffled = True
        self._draw_order()

    def reset(self) -> None:
        self._cursor = 0
        if self._shuffled:
            self._draw_order()

    def _draw_order(self) -> None:
        # the generator's state before the draw lets state_dict reproduce
        # the order without storing the permutation
        self._pre_draw_rng = self._rng.bit_generator.state
        self._order = self._rng.permutation(self._num_samples)

    def get_batch(self, batch_size: int
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The next (data, labels) batch, or None at the epoch's end."""
        if self._cursor + batch_size > self._num_samples:
            return None
        idx = np.arange(self._cursor, self._cursor + batch_size)
        if self._order is not None:
            idx = self._order[idx]
        self._cursor += batch_size
        return self._get(idx)

    def _get(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def batches(self, batch_size: int, drop_remainder: bool = True,
                reset: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One epoch of batches; the remainder is dropped unless
        ``drop_remainder`` is False. ``reset=False`` goes on from the
        current cursor (a resumed epoch)."""
        if reset:
            self.reset()
        while True:
            b = self.get_batch(batch_size)
            if b is None:
                if not drop_remainder:
                    tail = self._num_samples - self._cursor
                    if tail > 0:
                        idx = np.arange(self._cursor, self._num_samples)
                        if self._order is not None:
                            idx = self._order[idx]
                        self._cursor = self._num_samples
                        yield self._get(idx)
                return
            yield b

    def steps_per_epoch(self, batch_size: int) -> int:
        return self._num_samples // batch_size

    def remaining_batches(self, batch_size: int) -> int:
        """Complete batches left before the cursor ends the epoch."""
        return max(0, self._num_samples - self._cursor) // batch_size

    def state_dict(self) -> dict:
        return {"cursor": int(self._cursor),
                "shuffled": bool(self._shuffled),
                "has_order": self._order is not None,
                "pre_draw_rng": getattr(self, "_pre_draw_rng", None),
                "rng": self._rng.bit_generator.state}

    def load_state_dict(self, state: dict) -> None:
        self._shuffled = bool(state["shuffled"])
        if state.get("has_order") and state.get("pre_draw_rng") is not None:
            self._rng.bit_generator.state = state["pre_draw_rng"]
            self._draw_order()      # leaves the generator at "rng"
        else:
            self._order = None
        self._rng.bit_generator.state = state["rng"]
        self._cursor = int(state["cursor"])


class ArrayDataLoader(DataLoader):
    """In-memory (data, labels) arrays. A C-contiguous f32 or u8 array of
    two or more dims gathers its batches on the native runtime's threads
    where it is built (``native.api.gather_rows``: the same bytes as numpy's
    indexing)."""

    def __init__(self, data: np.ndarray, labels: np.ndarray, seed: int = 0):
        from .. import native

        super().__init__(seed)
        if len(data) != len(labels):
            raise ValueError(f"data/labels length mismatch: {len(data)} vs "
                             f"{len(labels)}")
        self.data = data
        self.labels = labels
        self._num_samples = len(data)
        self._data_shape = tuple(data.shape[1:])
        self._label_shape = tuple(labels.shape[1:])
        self._native_gather = (isinstance(data, np.ndarray) and data.ndim >= 2
                               and data.dtype in (np.float32, np.uint8)
                               and data.flags["C_CONTIGUOUS"]
                               and native.available())

    def _get(self, indices):
        if self._native_gather:
            from ..native import api

            return api.gather_rows(self.data, indices), self.labels[indices]
        return self.data[indices], self.labels[indices]


class SyntheticDataLoader(ArrayDataLoader):
    """Random but fixed data, drawn once from ``seed`` (``shuffle`` reorders
    the same samples): standard normal data and uniform int32 labels."""

    def __init__(self, num_samples: int, data_shape: Sequence[int],
                 num_classes: int, seed: int = 0, dtype=np.float32):
        gen = np.random.default_rng(seed)
        data = gen.standard_normal(
            (num_samples,) + tuple(data_shape)).astype(dtype)
        labels = gen.integers(0, num_classes, num_samples).astype(np.int32)
        self.num_classes = num_classes
        super().__init__(data, labels, seed)


def split_microbatches(data: np.ndarray, labels: np.ndarray,
                       num_microbatches: int
                       ) -> Sequence[Tuple[np.ndarray, np.ndarray]]:
    """Split a batch into ``num_microbatches`` equal parts along axis 0."""
    if len(data) % num_microbatches:
        raise ValueError(f"batch {len(data)} not divisible by "
                         f"num_microbatches {num_microbatches}")
    return list(zip(np.split(data, num_microbatches),
                    np.split(labels, num_microbatches)))


def stage_batch(batch, device) -> tuple:
    """Each numpy array of ``batch`` as a tensor on ``device``: through a
    pinned host tensor and a ``non_blocking`` copy for a CUDA device."""
    dev = torch.device(device)
    out = []
    for a in batch:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        elif t.device != dev:
            t = t.to(dev)
        out.append(t)
    return tuple(out)


def prefetch(iterator: Iterator, size: int = 2, to_device=True) -> Iterator:
    """Assemble and stage batches on a producer thread, ``size`` ahead.

    ``to_device``: a callable(batch) -> batch places each batch; a device
    (``"cuda"``, ``torch.device``) stages its numpy arrays there
    (``stage_batch``); True stages on the card ("cuda"); False or None
    stages nothing. A producer failure is raised in the consumer; a
    consumer that stops early stops the producer. Under ``TNN_PIN_IO=1``
    the producer pins itself to the IO cpu set (``utils.affinity``)."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()
    err: list = []
    if callable(to_device):
        place = to_device
    elif to_device is True:
        place = functools.partial(stage_batch, device="cuda")
    elif to_device:
        place = functools.partial(stage_batch, device=to_device)
    else:
        place = None

    def producer():
        from ..utils import affinity

        affinity.pin_io_thread()
        try:
            for item in iterator:
                if place is not None:
                    item = place(item)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except Exception as e:  # noqa: BLE001 — raised in the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        # abandoned mid-epoch: unblock and stop the producer
        stop.set()
        while True:
            try:
                if q.get_nowait() is sentinel:
                    break
            except queue.Empty:
                if not t.is_alive():
                    break
                t.join(timeout=0.05)
