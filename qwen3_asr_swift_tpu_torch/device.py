"""Explicit device resolution.

Every entry point of the port runs on the card unless the caller asks for
the CPU: ``device`` defaults to ``"cuda"``, and nothing picks the CPU
behind the caller's back. Asking for a CUDA device on a machine without
one raises instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cpu"``, ``"cuda"``, ``"cuda:N"``, a ``torch.device`` or ``None``
    (the first card) → a ``torch.device``. Raises ``RuntimeError`` for a
    CUDA device that this machine does not have, and ``ValueError`` for any
    other type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but torch sees no CUDA device")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"device {device!r} requested but only "
                               f"{torch.cuda.device_count()} CUDA device(s) exist")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev
