"""The device default of the port's entry points.

Every public function that takes a `device` runs on the CUDA device when it
is given none: the port is written for the card, and the CPU is something a
caller (the CPU tests) asks for by name.  Where there is no CUDA a call
without a device raises; it never carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device` as a torch.device, or the current CUDA device when it is
    None; a CUDA device always carries its index ('cuda' -> 'cuda:0'), so
    devices compare equal to the tensors placed on them."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: the port runs on the card unless the caller "
                               "passes a device (device='cpu' for the plain torch path)")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
