"""Device resolution shared by every entry point of the port.

The port runs on the card: ``device=None`` means CUDA, and a host without a
visible CUDA device raises instead of carrying on on the CPU.  The CPU runs
only when a caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev
