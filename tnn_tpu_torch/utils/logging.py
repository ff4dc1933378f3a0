"""Console and file logger (``tnn_tpu.utils.logging``): console and file
sinks, level filtering and process-global named loggers, on the standard
``logging`` module. The same logger names as the JAX package ("tnn.train")
name the same ``logging`` loggers, so one process running both packages
shares their sinks.
"""
from __future__ import annotations

import logging
import os
import sys
import time
from typing import Dict, Optional

_FORMAT = "%(asctime)s.%(msecs)03d [%(levelname)s] %(name)s: %(message)s"
_DATEFMT = "%H:%M:%S"

_loggers: Dict[str, "Logger"] = {}


class Logger:
    """Thin veneer over ``logging.Logger`` adding a file-sink helper and timers."""

    def __init__(self, name: str = "tnn", level: str = "info",
                 log_file: Optional[str] = None):
        self._log = logging.getLogger(name)
        self._log.propagate = False
        self.set_level(level)
        if not self._log.handlers:
            console = logging.StreamHandler(sys.stdout)
            console.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
            self._log.addHandler(console)
        if log_file:
            self.add_file_sink(log_file)

    def add_file_sink(self, path: str) -> None:
        current = {h.baseFilename for h in self._log.handlers
                   if isinstance(h, logging.FileHandler)}
        if os.path.abspath(path) in current:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fh = logging.FileHandler(path)
        fh.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
        self._log.addHandler(fh)

    def set_file_sink(self, path: Optional[str]) -> None:
        """Replace ALL file sinks with ``path`` (None = console only). For per-run
        logs: keeps run B's lines out of run A's file."""
        for h in [h for h in self._log.handlers
                  if isinstance(h, logging.FileHandler)]:
            self._log.removeHandler(h)
            h.close()
        if path:
            self.add_file_sink(path)

    def set_level(self, level: str) -> None:
        self._log.setLevel(getattr(logging, level.upper()))

    def debug(self, msg, *a):
        self._log.debug(msg, *a)

    def info(self, msg, *a):
        self._log.info(msg, *a)

    def warning(self, msg, *a):
        self._log.warning(msg, *a)

    def error(self, msg, *a):
        self._log.error(msg, *a)

    class _Timer:
        def __init__(self, logger: "Logger", label: str):
            self._logger, self._label = logger, label

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._logger.info("%s took %.1f ms", self._label,
                              (time.perf_counter() - self._t0) * 1e3)

    def timed(self, label: str) -> "_Timer":
        """``with log.timed("epoch"):`` — logs elapsed wall time at exit."""
        return self._Timer(self, label)


def get_logger(name: str = "tnn", level: Optional[str] = None,
               log_file: Optional[str] = None) -> Logger:
    """Process-global named loggers.

    A cached logger picks up a newly requested ``log_file`` (extra sink); ``level``
    only reconfigures when explicitly passed, so a default-level call never
    downgrades a logger someone set to debug.
    """
    if name not in _loggers:
        _loggers[name] = Logger(name, level or "info", log_file)
    else:
        log = _loggers[name]
        if level is not None:
            log.set_level(level)
        if log_file:
            log.add_file_sink(log_file)
    return _loggers[name]
