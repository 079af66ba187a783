"""Where the port's entry points run: the card unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the card.  Without CUDA, raise unless the caller asked
    for the CPU: the evaluator never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" to evaluate on the CPU'
        )
    return dev
