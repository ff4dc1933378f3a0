"""Host and device memory readings (``tnn_tpu.utils.hardware``).

``memory_usage_kb`` is the process's resident set; ``device_memory_stats``
reads the card's allocator through ``torch.cuda.memory_stats``, where the
JAX package's ``hbm_stats`` reads the TPU's. ``cpu_info`` and
``device_info`` come with ``cli/hardware_info`` (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

import torch


def memory_usage_kb() -> int:
    """Current process RSS in KiB (0 where ``/proc`` is not readable)."""
    try:
        with open("/proc/self/status", "r") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def device_memory_stats(device=None) -> Dict[str, int]:
    """The card's memory in bytes under the JAX package's key names:
    ``bytes_in_use`` and ``peak_bytes_in_use`` (the caching allocator's
    current and peak allocated bytes) and ``bytes_limit`` (the card's
    total). Empty for a CPU device or without a card."""
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type != "cuda") \
            or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                dev if dev is not None else torch.cuda.current_device())
                .total_memory)}
