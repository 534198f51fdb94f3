"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the given one, else the current
    CUDA card. With no card and no explicit device this raises: nothing
    moves to the CPU unless the caller asks for it."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {dev} requested but no CUDA device is available")
            if dev.index is None:
                # "cuda" names the current card: the index tensors report.
                dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def device_name(dev: torch.device) -> str:
    """Human name of ``dev``: the card's name, or 'cpu'."""
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type
