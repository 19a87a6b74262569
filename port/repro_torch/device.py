"""Device resolution shared by every entry point of the port.

``cuda`` is the default; the CPU is used only when the caller asks for
it (the CPU tests do).  Asking for ``cuda`` where there is none raises:
nothing drops quietly to the CPU.
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; any ``cuda`` device must be available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on cuda by default, and torch.cuda is not "
            "available here; pass device='cpu' to run the plain versions")
    return dev
