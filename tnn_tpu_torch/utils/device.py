"""Device selection for the port's entry points.

Entry points take an explicit ``device`` and default to ``"cuda"``. A run
that asks for the card on a host without one raises: nothing falls back to
the CPU behind the caller's back. Only callers that pass ``device="cpu"``
(the tests) run on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
