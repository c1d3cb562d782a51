"""MLP classifier (BASELINE config 1: MNIST MLP single-run lagom parity); the
port's counterpart of :class:`maggy_tpu.models.mlp.MLP`.

The same layers under the same names: ``dense_0 .. dense_{n-1}`` with ReLU
(and dropout when set), then ``head``. flax infers a layer's input width at
its first call; a torch layer needs it up front, so ``in_features`` is the
flattened width of one example. Weights are drawn as flax's ``he_normal``
draws them (a normal truncated at two standard deviations, variance
2 / fan_in), biases are zero. :func:`maggy_tpu_torch.convert.mlp_params_from_flax`
carries a flax tree across.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from maggy_tpu_torch.util import resolve_device

# std of a unit normal truncated to [-2, 2]; flax divides by it so that the
# truncated draw keeps the variance it asks for
_TRUNC_STD = 0.87962566103423978


class MLP(nn.Module):
    """``forward(x [B, ...]) -> logits [B, num_classes]``. ``device`` defaults
    to CUDA and raises without it; ``device="meta"`` builds the shapes only."""

    def __init__(
        self,
        in_features: int,
        features: Sequence[int] = (128, 64),
        num_classes: int = 10,
        dtype: torch.dtype = torch.float32,
        dropout: float = 0.0,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.features = tuple(features)
        self.dtype = dtype
        self.dropout = dropout
        widths = (in_features, *self.features)
        for i in range(len(self.features)):
            self.add_module(f"dense_{i}", nn.Linear(widths[i], widths[i + 1], dtype=dtype, device=device))
        self.head = nn.Linear(widths[-1], num_classes, dtype=dtype, device=device)
        if device.type != "meta":
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in self._layers():
            std = math.sqrt(2.0 / layer.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            layer.bias.zero_()

    def _layers(self):
        return [getattr(self, f"dense_{i}") for i in range(len(self.features))] + [self.head]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(len(self.features)):
            x = torch.relu(getattr(self, f"dense_{i}")(x))
            if self.dropout:
                x = nn.functional.dropout(x, self.dropout, self.training)
        return self.head(x)
