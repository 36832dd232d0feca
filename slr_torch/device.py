"""Where the port's entry points run: on the card unless the caller asks
for the CPU, and never on the CPU in silence when the card is missing."""

from __future__ import annotations

import torch


def require_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it is a CUDA device and
    no CUDA device is present (pass ``"cpu"`` to run on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this entry point runs on the card and no CUDA device "
                           "is available; pass device='cpu' for the CPU")
    return device
