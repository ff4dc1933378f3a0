"""Framed-TCP message transport (``tnn_tpu.distributed.transport``): the
native runtime's (``native/src/control.cpp``) with a pure-Python fallback.

Both speak the same wire format — [u32 magic "TNNC"][u32 command][u64 len][payload]
— the JAX package's too, so a native coordinator can drive Python-fallback
workers, and either package's coordinator the other's workers.

Recv surfaces two sentinel events besides payload frames:
  ("connect", conn_id)    — a peer connected to our listener
  ("disconnect", conn_id) — a peer went away (socket closed/reset)
"""
from __future__ import annotations

import ctypes
import queue
import socket
import struct
import threading
from typing import Optional, Tuple

_MAGIC = 0x544E4E43

# (kind, conn, command, payload) where kind in {"msg", "connect", "disconnect"}
Event = Tuple[str, int, int, bytes]


class Transport:
    """Abstract endpoint: optional listener + outbound connections + one inbox."""

    def port(self) -> int:
        raise NotImplementedError

    def connect(self, host: str, port: int) -> int:
        raise NotImplementedError

    def send(self, conn: int, command: int, payload: bytes = b"") -> bool:
        raise NotImplementedError

    def recv(self, timeout: float = 1.0) -> Optional[Event]:
        raise NotImplementedError

    def close_conn(self, conn: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeTransport(Transport):
    """ctypes wrapper over native/src/control.cpp."""

    def __init__(self, bind: str = "", listen_port: Optional[int] = 0):
        from ..native.lib import get_lib

        self._lib = get_lib()
        port = -1 if listen_port is None else int(listen_port)
        self._h = self._lib.tnn_ctl_create(bind.encode(), port)
        if not self._h:
            raise OSError(f"cannot create control endpoint on {bind}:{listen_port}")
        self._buf = ctypes.create_string_buffer(1 << 16)

    def port(self) -> int:
        return int(self._lib.tnn_ctl_port(self._h))

    def connect(self, host: str, port: int) -> int:
        host = socket.gethostbyname(host)  # native side takes dotted quads
        conn = int(self._lib.tnn_ctl_connect(self._h, host.encode(), int(port)))
        if conn < 0:
            raise ConnectionError(f"cannot connect to {host}:{port}")
        return conn

    def send(self, conn: int, command: int, payload: bytes = b"") -> bool:
        arr = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload) \
            if payload else None
        rc = self._lib.tnn_ctl_send(self._h, conn, command, arr, len(payload))
        return rc == 0

    def recv(self, timeout: float = 1.0) -> Optional[Event]:
        conn = ctypes.c_int64()
        cmd = ctypes.c_int32()
        buf = self._buf
        n = self._lib.tnn_ctl_recv(
            self._h, timeout, ctypes.byref(conn), ctypes.byref(cmd),
            ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), len(buf))
        if n < 0:
            return None
        if n > len(buf):  # two-phase: grow and consume the queued frame
            self._buf = buf = ctypes.create_string_buffer(int(n))
            n = self._lib.tnn_ctl_recv(
                self._h, timeout, ctypes.byref(conn), ctypes.byref(cmd),
                ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), len(buf))
        if conn.value == -2:
            return ("connect", cmd.value, 0, b"")
        if conn.value == -3:
            return ("disconnect", cmd.value, 0, b"")
        return ("msg", conn.value, cmd.value, buf.raw[:n])

    def close_conn(self, conn: int) -> None:
        self._lib.tnn_ctl_close_conn(self._h, conn)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tnn_ctl_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PyTransport(Transport):
    """Pure-Python fallback speaking the same frames (socket + threads)."""

    def __init__(self, bind: str = "", listen_port: Optional[int] = 0):
        self._inbox: "queue.Queue[Event]" = queue.Queue()
        self._conns = {}
        self._send_locks = {}  # conn -> Lock; frames must not interleave
        self._next = 0
        self._lock = threading.Lock()
        self._running = True
        self._listener = None
        if listen_port is not None:
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind((bind or "0.0.0.0", int(listen_port)))
            self._listener.listen(64)
            threading.Thread(target=self._accept_loop, daemon=True).start()

    def _add(self, sock: socket.socket) -> int:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._lock:
            conn = self._next
            self._next += 1
            self._conns[conn] = sock
            self._send_locks[conn] = threading.Lock()
        threading.Thread(target=self._read_loop, args=(conn, sock),
                         daemon=True).start()
        return conn

    def _accept_loop(self):
        while self._running:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            conn = self._add(sock)
            self._inbox.put(("connect", conn, 0, b""))

    def _read_loop(self, conn: int, sock: socket.socket):
        def read_exact(n):
            data = b""
            while len(data) < n:
                chunk = sock.recv(n - len(data))
                if not chunk:
                    raise ConnectionError
                data += chunk
            return data

        broke = False
        try:
            while self._running:
                magic, cmd, ln = struct.unpack("<IIQ", read_exact(16))
                if magic != _MAGIC:
                    raise ConnectionError
                payload = read_exact(ln) if ln else b""
                self._inbox.put(("msg", conn, cmd, payload))
        except (ConnectionError, OSError):
            broke = True
        finally:
            with self._lock:
                alive = conn in self._conns
                self._conns.pop(conn, None)
                send_lock = self._send_locks.pop(conn, None)
            if broke and alive and self._running:
                self._inbox.put(("disconnect", conn, 0, b""))
            # the reader OWNS the close: close()/close_conn() only shutdown()
            # to wake this recv — closing the fd from another thread while a
            # recv/send is in the syscall races on the descriptor (fd reuse
            # hazard). Shutting down BOTH directions first kicks any stalled
            # in-flight sendall out of its syscall (a peer FIN alone does
            # not error the send side); then taking the send lock waits for
            # it to release before the fd goes away.
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                if send_lock is not None:
                    with send_lock:
                        sock.close()
                else:
                    sock.close()
            except OSError:
                pass

    def port(self) -> int:
        return self._listener.getsockname()[1] if self._listener else 0

    def connect(self, host: str, port: int) -> int:
        sock = socket.create_connection((host, port), timeout=10)
        sock.settimeout(None)
        return self._add(sock)

    def send(self, conn: int, command: int, payload: bytes = b"") -> bool:
        # Worker sends from several threads (event loop, heartbeat, profiler);
        # a per-connection lock keeps large frames from interleaving on the wire
        # (the native transport's send_mu, native/src/control.cpp, mirrored here).
        with self._lock:
            sock = self._conns.get(conn)
            send_lock = self._send_locks.get(conn)
        if sock is None or send_lock is None:
            return False
        try:
            with send_lock:
                sock.sendall(
                    struct.pack("<IIQ", _MAGIC, command, len(payload)) + payload)
            return True
        except OSError:
            return False

    def recv(self, timeout: float = 1.0) -> Optional[Event]:
        try:
            return self._inbox.get(timeout=timeout)
        except queue.Empty:
            return None

    def close_conn(self, conn: int) -> None:
        with self._lock:
            # the send lock stays for the READER to pop: it must be able to
            # wait out an in-flight sendall before closing the fd
            sock = self._conns.pop(conn, None)
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)  # reader wakes and closes
            except OSError:
                pass

    def close(self) -> None:
        self._running = False
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            socks = list(self._conns.values())
            self._conns.clear()
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)  # readers wake and close
            except OSError:
                pass


def make_transport(bind: str = "", listen_port: Optional[int] = 0,
                   prefer_native: bool = True) -> Transport:
    """The native transport where the port's ``libtnn_host`` loads,
    the Python one otherwise."""
    if prefer_native:
        from .. import native

        if native.available():
            return NativeTransport(bind, listen_port)
    return PyTransport(bind, listen_port)
