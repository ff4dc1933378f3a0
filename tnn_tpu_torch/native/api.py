"""numpy-facing wrappers over the host runtime's entry points
(``tnn_tpu.native.api``).

The caller checks ``native.available()`` first: the loaders keep their
numpy paths where the library is not built. Malformed data raises
ValueError.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from .lib import get_lib

_c = ctypes


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(_c.POINTER(ctype))


def decode_image_batch(paths, out_h: int, out_w: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode + bilinear-resize a batch of image files across threads.

    PNG (from-spec decoder over the system zlib) and baseline+progressive
    JPEG (from-spec decoder, native/src/jpeg.cpp) dispatch on magic bytes.
    Returns (batch u8 [N, out_h, out_w, 3], ok bool [N]); failed entries
    (12-bit/CMYK/arithmetic/lossless JPEG, interlaced/16-bit PNG, other
    formats) are zeroed with ok=False so the caller can fall back per
    image. Parity: the reference's
    threaded stb_image decode (src/data_loading/stb_image_impl.cpp).
    """
    lib = get_lib()
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    ok = np.zeros(n, np.uint8)
    arr = (_c.c_char_p * n)(*[p.encode() for p in paths])
    lib.tnn_decode_image_batch(arr, n, int(out_h), int(out_w),
                               _ptr(out, _c.c_uint8), _ptr(ok, _c.c_uint8))
    return out, ok.astype(bool)


decode_png_batch = decode_image_batch  # back-compat name


def resize_bilinear_batch(frames: np.ndarray, out_h: int, out_w: int
                          ) -> np.ndarray:
    """Threaded bilinear resize of a (N, H, W, 3) uint8 batch — the raw-array
    (.npy) loader path, where there is no decode for the threaded decoder to
    hide the resize in. Same sampling convention as datasets._resize_bilinear
    (align-corners=False, +0.5 round), so native and numpy paths agree."""
    frames = np.ascontiguousarray(frames, np.uint8)
    n, in_h, in_w, c = frames.shape
    if c != 3:
        raise ValueError(f"expected RGB frames, got {frames.shape}")
    lib = get_lib()
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    lib.tnn_resize_bilinear_batch(
        _ptr(frames, _c.c_uint8), _c.c_int64(n), int(in_h), int(in_w),
        int(out_h), int(out_w), _ptr(out, _c.c_uint8))
    return out


# -- parsers -----------------------------------------------------------------


def mnist_csv(path: str, header: bool, pixels: int = 784
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an MNIST-style CSV -> (images u8 [N, pixels], labels i32 [N])."""
    lib = get_lib()
    n = lib.tnn_mnist_csv_rows(path.encode(), int(header))
    if n < 0:
        raise ValueError(f"cannot read {path}")
    images = np.empty((n, pixels), np.uint8)
    labels = np.empty((n,), np.int32)
    got = lib.tnn_mnist_csv_parse(path.encode(), int(header),
                                  _ptr(images, _c.c_uint8), _ptr(labels, _c.c_int32),
                                  n, pixels)
    if got != n:
        raise ValueError(f"{path}: malformed CSV (parsed {got} of {n} rows)")
    return images, labels


def cifar10(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse one CIFAR-10 .bin -> (images u8 [N,32,32,3] HWC, labels i32 [N])."""
    lib = get_lib()
    n = lib.tnn_cifar_records(path.encode(), 1)
    if n < 0:
        raise ValueError(f"cannot read {path}")
    images = np.empty((n, 32, 32, 3), np.uint8)
    labels = np.empty((n,), np.int32)
    lib.tnn_cifar10_parse(path.encode(), _ptr(images, _c.c_uint8),
                          _ptr(labels, _c.c_int32), n)
    return images, labels


def cifar100(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse CIFAR-100 .bin -> (images u8 [N,32,32,3], coarse i32, fine i32)."""
    lib = get_lib()
    n = lib.tnn_cifar_records(path.encode(), 2)
    if n < 0:
        raise ValueError(f"cannot read {path}")
    images = np.empty((n, 32, 32, 3), np.uint8)
    coarse = np.empty((n,), np.int32)
    fine = np.empty((n,), np.int32)
    lib.tnn_cifar100_parse(path.encode(), _ptr(images, _c.c_uint8),
                           _ptr(coarse, _c.c_int32), _ptr(fine, _c.c_int32), n)
    return images, coarse, fine


# -- batch assembly ----------------------------------------------------------


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """dst[i] = src[idx[i]] for 2-D+ src, threaded. Supports f32 and u8."""
    lib = get_lib()
    idx = np.ascontiguousarray(idx, np.int64)
    src2 = np.ascontiguousarray(src).reshape(len(src), -1)
    out = np.empty((len(idx), src2.shape[1]), src2.dtype)
    if src2.dtype == np.float32:
        lib.tnn_gather_rows_f32(_ptr(src2, _c.c_float), src2.shape[1],
                                _ptr(idx, _c.c_int64), len(idx),
                                _ptr(out, _c.c_float))
    elif src2.dtype == np.uint8:
        lib.tnn_gather_rows_u8(_ptr(src2, _c.c_uint8), src2.shape[1],
                               _ptr(idx, _c.c_int64), len(idx),
                               _ptr(out, _c.c_uint8))
    else:
        raise ValueError(f"unsupported gather dtype {src2.dtype}")
    return out.reshape((len(idx),) + src.shape[1:])


def gather_normalize(src_u8: np.ndarray, idx: np.ndarray,
                     mean: Optional[np.ndarray] = None,
                     std: Optional[np.ndarray] = None) -> np.ndarray:
    """Fused batch assemble: out[i] = (src[idx[i]]/255 - mean)/std as f32.

    ``src_u8`` is [N, ..., C] HWC uint8; mean/std are per-channel (len C) or None.
    """
    lib = get_lib()
    idx = np.ascontiguousarray(idx, np.int64)
    channels = src_u8.shape[-1] if src_u8.ndim > 1 else 1
    src2 = np.ascontiguousarray(src_u8).reshape(len(src_u8), -1)
    out = np.empty((len(idx), src2.shape[1]), np.float32)
    mean_p = _ptr(np.ascontiguousarray(mean, np.float32), _c.c_float) if mean is not None else None
    std_p = _ptr(np.ascontiguousarray(std, np.float32), _c.c_float) if std is not None else None
    lib.tnn_gather_u8_normalize_f32(_ptr(src2, _c.c_uint8), src2.shape[1],
                                    _ptr(idx, _c.c_int64), len(idx),
                                    _ptr(out, _c.c_float), mean_p, std_p, channels)
    return out.reshape((len(idx),) + src_u8.shape[1:])


def epoch_permutation(n: int, seed: int) -> np.ndarray:
    lib = get_lib()
    out = np.empty((n,), np.int64)
    lib.tnn_epoch_permutation(n, seed, _ptr(out, _c.c_int64))
    return out


# -- BPE tokenizer -----------------------------------------------------------


class BpeTokenizer:
    """Native GPT-2 BPE over a reference-format vocab.bin (encode + decode)."""

    def __init__(self, vocab_path: str):
        self._lib = get_lib()
        self._h = self._lib.tnn_bpe_load(vocab_path.encode())
        if not self._h:
            raise ValueError(f"cannot load vocab {vocab_path}")

    @property
    def vocab_size(self) -> int:
        return int(self._lib.tnn_bpe_vocab_size(self._h))

    @property
    def eot_token(self) -> Optional[int]:
        t = int(self._lib.tnn_bpe_eot(self._h))
        return t if t >= 0 else None

    def encode(self, text: str) -> np.ndarray:
        raw = text.encode("utf-8")
        n = self._lib.tnn_bpe_encode(self._h, raw, len(raw), None, 0)
        out = np.empty((n,), np.int32)
        self._lib.tnn_bpe_encode(self._h, raw, len(raw), _ptr(out, _c.c_int32), n)
        return out

    def decode_bytes(self, ids: np.ndarray) -> bytes:
        ids = np.ascontiguousarray(ids, np.int32)
        n = self._lib.tnn_bpe_decode(self._h, _ptr(ids, _c.c_int32), len(ids),
                                     None, 0)
        buf = _c.create_string_buffer(int(n))
        self._lib.tnn_bpe_decode(self._h, _ptr(ids, _c.c_int32), len(ids), buf, n)
        return buf.raw

    def decode(self, ids) -> str:
        return self.decode_bytes(np.asarray(ids, np.int32)).decode(
            "utf-8", errors="replace")

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tnn_bpe_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# -- token stream ------------------------------------------------------------


class TokenFile:
    """mmap'd token file with threaded window reads (i32 output)."""

    def __init__(self, path: str, dtype=np.uint16):
        self._lib = get_lib()
        sizes = {np.dtype(np.uint16): 2, np.dtype(np.int32): 4,
                 np.dtype(np.uint32): 4}
        if np.dtype(dtype) not in sizes:
            raise ValueError(f"native token reader supports u16/i32/u32, "
                             f"not {np.dtype(dtype)}")
        nbytes = sizes[np.dtype(dtype)]
        self._h = self._lib.tnn_tokens_open(path.encode(), nbytes)
        if not self._h:
            raise ValueError(f"cannot mmap token file {path}")

    def __len__(self) -> int:
        return int(self._lib.tnn_tokens_len(self._h))

    def windows(self, offsets: np.ndarray, window: int) -> np.ndarray:
        offsets = np.ascontiguousarray(offsets, np.int64)
        out = np.empty((len(offsets), window), np.int32)
        self._lib.tnn_tokens_windows(self._h, _ptr(offsets, _c.c_int64),
                                     len(offsets), window, _ptr(out, _c.c_int32))
        return out

    def close(self) -> None:
        if self._h:
            self._lib.tnn_tokens_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
