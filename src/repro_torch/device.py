"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. Raises when a CUDA device is asked for (or
    defaulted to) and there is none: the port never carries on on the CPU
    unless the caller passed `device="cpu"`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def block_until_ready(t: torch.Tensor) -> torch.Tensor:
    """Wait until the device has computed `t` (a no-op on the CPU)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return t
