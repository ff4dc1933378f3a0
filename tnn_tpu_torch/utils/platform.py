"""The device an entry point runs on (``tnn_tpu.utils.platform``).

The JAX package's ``apply_env_platform`` forces JAX's platform from
``TNN_PLATFORM``. In the port it picks the torch device: ``TNN_PLATFORM=cpu``
selects the CPU, the only way the image CLIs (``cli.trainer``,
``cli.inferencer``) run off the card; unset, or any other value, selects
the card ("cuda"), and a run without one raises
(``utils.device.resolve_device``).
"""
from __future__ import annotations

import os

import torch

from .device import resolve_device


def apply_env_platform() -> torch.device:
    """The device ``TNN_PLATFORM`` selects (see the module docstring)."""
    name = os.environ.get("TNN_PLATFORM", "").strip().lower()
    return resolve_device("cpu" if name == "cpu" else "cuda")
