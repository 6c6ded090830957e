"""Device resolution for the port's entry points.

`None` means the card: the entry points run on CUDA unless the caller asks
for the CPU by name. There is no silent fallback — a request for CUDA on a
machine without it raises.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """None -> cuda (raising when CUDA is absent); anything else is taken
    as an explicit request and checked the same way."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
