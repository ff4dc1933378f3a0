"""Build and load the host runtime's library, ``libtnn_host.so``
(``tnn_tpu.native.lib``).

The sources are the repository's ``native/src/*.cpp``, read only: the
port compiles them with ``g++`` into ``build/native/`` at the repository
root, never into ``native/build/``, which the JAX package builds into.
One ``g++`` per source runs at once, into a scratch directory, and the
linked library is renamed into place under a file lock, so processes
that start together (test workers) build it once between them. ``TNN_NATIVE=0`` turns the runtime off;
``TNN_NATIVE_LIB`` loads another build of the library (a sanitizer build)
in its place. A library that lacks a symbol is rebuilt once.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
SRC_DIR = _REPO_ROOT / "native" / "src"
BUILD_DIR = _REPO_ROOT / "build" / "native"
_SO_PATH = Path(os.environ.get("TNN_NATIVE_LIB")
                or BUILD_DIR / "libtnn_host.so")

# native/Makefile's CXXFLAGS and LDFLAGS (tests hold the two equal)
CXXFLAGS = ["-O2", "-march=native", "-std=c++20", "-fPIC",
            "-fvisibility=hidden", "-Wall", "-Wextra", "-pthread"]
LDFLAGS = ["-shared", "-pthread"]


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def _has_zlib(cxx: str) -> bool:
    """Whether ``<zlib.h>`` is found (the Makefile links ``-lz`` only
    then; ``image.cpp`` compiles without PNG decoding otherwise)."""
    proc = subprocess.run([cxx, "-E", "-x", "c++", "-"],
                          input="#include <zlib.h>\n", capture_output=True,
                          text=True)
    return proc.returncode == 0


def _compile(out: Path) -> None:
    cxx = _cxx()
    if shutil.which(cxx) is None:
        raise RuntimeError(f"no C++ compiler ({cxx}) for the native runtime")
    work = Path(tempfile.mkdtemp(prefix="build-", dir=out.parent))
    try:
        sources = sorted(SRC_DIR.glob("*.cpp"))
        procs = [(src, subprocess.Popen(
            [cxx, *CXXFLAGS, "-c", str(src), "-o",
             str(work / f"{src.stem}.o")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)) for src in sources]
        failed = [(src, p.communicate()[0]) for src, p in procs
                  if p.wait() != 0]
        if failed:
            raise RuntimeError("native build failed:\n" + "\n".join(
                f"{src.name}: {log}" for src, log in failed))
        tmp = work / "libtnn_host.so"
        link = [cxx, *LDFLAGS, *(str(work / f"{s.stem}.o") for s in sources),
                *(["-lz"] if _has_zlib(cxx) else []), "-o", str(tmp)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native link failed:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)    # atomic: readers never see half a file
    finally:
        shutil.rmtree(work, ignore_errors=True)


def build_native(force: bool = False) -> str:
    """Compile ``libtnn_host.so`` unless it is built (``force`` rebuilds);
    returns its path and raises where the build fails."""
    out = BUILD_DIR / "libtnn_host.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if force or not out.exists():
            _compile(out)
    return str(out)


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    i64, i32, u8, u64 = c.c_int64, c.c_int32, c.c_uint8, c.c_uint64
    p = c.POINTER

    lib.tnn_mnist_csv_rows.restype = i64
    lib.tnn_mnist_csv_rows.argtypes = [c.c_char_p, c.c_int]
    lib.tnn_mnist_csv_parse.restype = i64
    lib.tnn_mnist_csv_parse.argtypes = [c.c_char_p, c.c_int, p(u8), p(i32),
                                        i64, i64]
    lib.tnn_cifar_records.restype = i64
    lib.tnn_cifar_records.argtypes = [c.c_char_p, c.c_int]
    lib.tnn_cifar10_parse.restype = i64
    lib.tnn_cifar10_parse.argtypes = [c.c_char_p, p(u8), p(i32), i64]
    lib.tnn_cifar100_parse.restype = i64
    lib.tnn_cifar100_parse.argtypes = [c.c_char_p, p(u8), p(i32), p(i32),
                                       i64]

    f32 = c.c_float
    lib.tnn_gather_rows_f32.restype = None
    lib.tnn_gather_rows_f32.argtypes = [p(f32), i64, p(i64), i64, p(f32)]
    lib.tnn_gather_rows_u8.restype = None
    lib.tnn_gather_rows_u8.argtypes = [p(u8), i64, p(i64), i64, p(u8)]
    lib.tnn_gather_u8_normalize_f32.restype = None
    lib.tnn_gather_u8_normalize_f32.argtypes = [p(u8), i64, p(i64), i64,
                                                p(f32), p(f32), p(f32), i64]
    lib.tnn_epoch_permutation.restype = None
    lib.tnn_epoch_permutation.argtypes = [i64, u64, p(i64)]

    lib.tnn_bpe_load.restype = c.c_void_p
    lib.tnn_bpe_load.argtypes = [c.c_char_p]
    lib.tnn_bpe_free.restype = None
    lib.tnn_bpe_free.argtypes = [c.c_void_p]
    lib.tnn_bpe_vocab_size.restype = i32
    lib.tnn_bpe_vocab_size.argtypes = [c.c_void_p]
    lib.tnn_bpe_eot.restype = i32
    lib.tnn_bpe_eot.argtypes = [c.c_void_p]
    lib.tnn_bpe_encode.restype = i64
    lib.tnn_bpe_encode.argtypes = [c.c_void_p, c.c_char_p, i64, p(i32), i64]
    lib.tnn_bpe_decode.restype = i64
    lib.tnn_bpe_decode.argtypes = [c.c_void_p, p(i32), i64, c.c_char_p, i64]

    lib.tnn_ctl_create.restype = c.c_void_p
    lib.tnn_ctl_create.argtypes = [c.c_char_p, c.c_int]
    lib.tnn_ctl_port.restype = c.c_int
    lib.tnn_ctl_port.argtypes = [c.c_void_p]
    lib.tnn_ctl_connect.restype = i64
    lib.tnn_ctl_connect.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
    lib.tnn_ctl_send.restype = c.c_int
    lib.tnn_ctl_send.argtypes = [c.c_void_p, i64, i32, p(u8), i64]
    lib.tnn_ctl_recv.restype = i64
    lib.tnn_ctl_recv.argtypes = [c.c_void_p, c.c_double, p(i64), p(i32),
                                 p(u8), i64]
    lib.tnn_ctl_close_conn.restype = None
    lib.tnn_ctl_close_conn.argtypes = [c.c_void_p, i64]
    lib.tnn_ctl_destroy.restype = None
    lib.tnn_ctl_destroy.argtypes = [c.c_void_p]

    lib.tnn_tokens_open.restype = c.c_void_p
    lib.tnn_tokens_open.argtypes = [c.c_char_p, c.c_int]
    lib.tnn_tokens_len.restype = i64
    lib.tnn_tokens_len.argtypes = [c.c_void_p]
    lib.tnn_tokens_windows.restype = None
    lib.tnn_tokens_windows.argtypes = [c.c_void_p, p(i64), i64, i64, p(i32)]
    lib.tnn_tokens_close.restype = None
    lib.tnn_tokens_close.argtypes = [c.c_void_p]

    lib.tnn_decode_png_batch.restype = i64
    lib.tnn_decode_png_batch.argtypes = [p(c.c_char_p), i64, c.c_int,
                                         c.c_int, p(u8), p(u8)]
    # the PNG and JPEG entry: a library built before it existed lacks the
    # symbol, which raises AttributeError and rebuilds (get_lib)
    lib.tnn_decode_image_batch.restype = i64
    lib.tnn_decode_image_batch.argtypes = [p(c.c_char_p), i64, c.c_int,
                                           c.c_int, p(u8), p(u8)]
    lib.tnn_resize_bilinear_batch.restype = None
    lib.tnn_resize_bilinear_batch.argtypes = [p(u8), i64, c.c_int, c.c_int,
                                              c.c_int, c.c_int, p(u8)]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use; None where it cannot be
    built or ``TNN_NATIVE`` turns it off."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried or os.environ.get("TNN_NATIVE", "1") in ("0", "false", "off"):
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not _SO_PATH.is_file():
                build_native()
            try:
                lib = ctypes.CDLL(str(_SO_PATH))
                _configure(lib)
            except AttributeError:
                build_native(force=True)
                lib = ctypes.CDLL(str(_SO_PATH))
                _configure(lib)
            _lib = lib
        except (OSError, RuntimeError, AttributeError,
                subprocess.SubprocessError):
            _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None
