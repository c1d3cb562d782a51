"""Small helpers shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. With no device given and no CUDA present this raises; it never
    drops to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def seed_everything(
    seed: int, device: Optional[Union[str, torch.device]] = None
) -> Tuple[np.random.Generator, torch.Generator]:
    """A seeded numpy Generator and a seeded ``torch.Generator`` on
    ``device`` (resolved as :func:`resolve_device` does). Nothing global is
    seeded: callers pass the generators where randomness is drawn."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return np.random.default_rng(seed), gen
