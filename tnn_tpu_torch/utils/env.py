"""``.env`` file loading and typed environment getters
(``tnn_tpu.utils.env``, copied so the port imports nothing of the JAX
package): ``load_env_file`` trims whitespace, skips comments, strips quotes
and exports into the process environment; ``Env.get(key, default)`` parses
the value as ``type(default)``.
"""
from __future__ import annotations

import os
from typing import Optional, Type, TypeVar

T = TypeVar("T")

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off", ""}


def _strip_inline_comment(value: str) -> str:
    if value and value[0] in "\"'":
        # comment starts only after the closing quote
        close = value.find(value[0], 1)
        if close != -1:
            pos = value.find("#", close + 1)
            if pos != -1:
                value = value[:pos]
    else:
        pos = value.find("#")
        if pos != -1:
            value = value[:pos]
    return value.strip()


def _unquote(value: str) -> str:
    if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
        return value[1:-1]
    return value


def load_env_file(path: str = "./.env", export: bool = True) -> dict:
    """Parse a ``.env`` file. Returns {key: value}; exports into os.environ by default.

    Grammar: ``KEY=VALUE`` lines, ``#`` comments (full-line
    and inline outside quotes), surrounding quotes stripped, malformed keys skipped.
    """
    parsed: dict = {}
    try:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.readlines()
    except OSError:
        return parsed
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key = key.strip()
        value = _unquote(_strip_inline_comment(value.strip()))
        if not key or any(c in key for c in "= \t"):
            continue
        parsed[key] = value
        if export:
            os.environ[key] = value
    return parsed


def _parse_bool(raw: str) -> bool:
    low = raw.strip().lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    raise ValueError(f"cannot parse {raw!r} as bool")


class Env:
    """Typed environment access."""

    @staticmethod
    def get(key: str, default: T, type_: Optional[Type] = None) -> T:
        """Read ``key`` from the environment, parsed as ``type_`` (defaults to
        ``type(default)``). Unset or unparseable -> ``default``."""
        raw = os.environ.get(key)
        if raw is None:
            return default
        ty = type_ or type(default)
        try:
            if ty is bool:
                return _parse_bool(raw)  # type: ignore[return-value]
            if ty is type(None):
                return raw  # type: ignore[return-value]
            return ty(raw)
        except (TypeError, ValueError):
            return default

    @staticmethod
    def has(key: str) -> bool:
        return key in os.environ
