"""Device choice for every entry point of the port.

``device=None`` means CUDA. Without a CUDA device an entry point raises
unless the caller asked for the CPU explicitly: the CPU runs the plain
PyTorch versions of the kernels, which is what the tests want and never
what a deployment should get by accident."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raises ``RuntimeError`` for CUDA without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "zebra_tpu_torch runs on CUDA unless asked otherwise, and no "
                "CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev
