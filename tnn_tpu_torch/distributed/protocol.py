"""The control plane's command protocol (``tnn_tpu.distributed.protocol``),
byte for byte the JAX package's: the same command numbers and the same
payloads, so either package's coordinator drives the other's workers.

Parity: the reference's 33-command enum (include/distributed/command_type.hpp:20-79)
minus the data-plane jobs (FORWARD_JOB/BACKWARD_JOB: tensors never travel
this channel) plus working health commands (the reference declares
HEALTH_CHECK/ERROR_REPORT but its handlers are stubs, worker.hpp:216-277).

Payloads are JSON (UTF-8): control messages are small and debuggability
beats binary packing at this layer. Payloads above ``COMPRESS_THRESHOLD``
bytes are zlib-compressed, tagged by a one-byte header (the reference
declares CompressionType {NONE, ZSTD, QUANTIZATION} in its packet format
but never implements any, packet.hpp:10-57).
"""
from __future__ import annotations

import enum
import json
import zlib
from typing import Any, Dict, Tuple

_RAW = b"\x00"
_ZLIB = b"\x01"
COMPRESS_THRESHOLD = 4096  # bytes of JSON before compression kicks in


class Command(enum.IntEnum):
    HANDSHAKE = 1          # worker -> coordinator: {"rank", "host", "devices"}
    HANDSHAKE_ACK = 2      # coordinator -> worker: {"rank", "world"}
    CONFIG_TRANSFER = 3    # coordinator -> worker: arbitrary config dict
    CONFIG_RECEIVED = 4    # worker -> coordinator ack
    TRAIN_MODE = 5
    EVAL_MODE = 6
    BARRIER = 7            # both ways: {"name"}; coordinator releases with BARRIER_OK
    BARRIER_OK = 8
    START_PROFILING = 9
    REPORT_PROFILING = 10  # worker -> coordinator: Profiler.to_dict()
    CLEAR_PROFILING = 11
    SAVE_TO_FILE = 12      # coordinator -> worker: {"path"}
    SAVED = 13
    HEARTBEAT = 14         # worker -> coordinator: {"rank", "seq"}
    HEALTH_CHECK = 15      # coordinator -> worker; worker answers HEALTH_OK
    HEALTH_OK = 16
    ERROR_REPORT = 17      # worker -> coordinator: {"rank", "error"}
    CUSTOM = 18            # user payloads {"name", ...} via Worker.on()
    SHUTDOWN = 19
    SHUTDOWN_ACK = 20


def pack(obj: Dict[str, Any]) -> bytes:
    raw = json.dumps(obj).encode()
    if len(raw) > COMPRESS_THRESHOLD:
        return _ZLIB + zlib.compress(raw, level=3)
    return _RAW + raw


def unpack(payload: bytes) -> Dict[str, Any]:
    if not payload:
        return {}
    tag, body = payload[:1], payload[1:]
    if tag == _ZLIB:
        body = zlib.decompress(body)
    elif tag != _RAW:
        raise ValueError(f"unknown payload tag {tag!r}")
    return json.loads(body.decode())


def parse(command: int, payload: bytes) -> Tuple[Command, Dict[str, Any]]:
    return Command(command), unpack(payload)
