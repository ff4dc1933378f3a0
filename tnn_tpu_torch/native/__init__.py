"""The native host runtime (``tnn_tpu.native``): ctypes bindings over
``libtnn_host.so``, built from the repository's ``native/src/`` into
``build/native/`` at first use (``native.lib``).

It covers the host's work around the card: the MNIST CSV and CIFAR
parsers, threaded batch gathers (with a fused normalize), mmap'd token
windows, the BPE encoder, PNG / JPEG decoding with a threaded bilinear
resize, and the control plane's framed-TCP transport. Each caller keeps
its numpy path for a host where ``available()`` is False: no compiler,
or ``TNN_NATIVE=0``.
"""
from . import api
from .lib import available, build_native, get_lib

__all__ = ["available", "build_native", "get_lib", "api"]
