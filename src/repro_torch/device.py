"""Device selection for every builder and engine of the port.

The port runs on the card unless the caller asks for the CPU: builders and
engines take ``device="cuda"`` by default.  Asking for the card where there
is none raises — nothing silently carries on on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev
