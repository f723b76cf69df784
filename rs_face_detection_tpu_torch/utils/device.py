"""Device resolution and host-to-device conversion."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent.

    A pipeline built for the card never carries on silently on the CPU.  A
    bare "cuda" names the current card by its index, so that two spellings
    of one card compare equal.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on `device` (no copy if there)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)
