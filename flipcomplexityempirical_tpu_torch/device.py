"""Device selection shared by the entry points.

Every entry point takes ``device="cuda"`` by default. Without a card the
caller has to ask for the CPU explicitly (``device="cpu"``): nothing falls
back to it silently, so a run that meant to measure the card never
measures the host instead.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev


def check_on(device: torch.device, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on ``device``'s type (the index is
    left to torch's own checks)."""
    for t in tensors:
        if t.device.type != device.type:
            raise ValueError(f"tensor on {t.device}, expected {device}")
