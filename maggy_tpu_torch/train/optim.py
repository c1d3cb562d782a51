"""Optimizers with the JAX package's (optax's) defaults."""

from __future__ import annotations

import functools
from typing import Callable, Iterable

import torch


def adamw(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
) -> Callable[[Iterable[torch.nn.Parameter]], torch.optim.AdamW]:
    """``optax.adamw`` as a ``torch.optim.AdamW`` factory: call it on the
    parameters. optax decays every parameter (``mask=None``) with a default
    weight decay of 1e-4, where torch's default is 1e-2; the update
    ``-lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p)`` is the same
    in both."""
    return functools.partial(
        torch.optim.AdamW, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay
    )
