"""The control plane (``tnn_tpu.distributed``): a coordinator and its
workers over framed TCP.

It carries config deploy, barriers, profile collection, heartbeats and
failure detection, save requests and shutdown (the native transport in
``native/src/control.cpp``, with a pure-Python fallback). Tensors never
travel this channel. The wire format is the JAX package's byte for byte,
so either package's coordinator drives the other's workers.

Parity: Coordinator (include/distributed/coordinator.hpp:50), Worker event
loop (worker.hpp:41), CommandType protocol (command_type.hpp:20-79).
"""
from .coordinator import Coordinator
from .protocol import Command
from .transport import Transport, make_transport
from .worker import Worker

__all__ = ["Transport", "make_transport", "Command", "Coordinator", "Worker"]
