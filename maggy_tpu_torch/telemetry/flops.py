"""FLOPs/MFU estimation for telemetry gauges.

Counterpart of :mod:`maggy_tpu.telemetry.flops`, on torch: training
FLOPs/token ≈ 6·params (forward and backward matmuls), against the card's
peak dense bf16 rate, looked up by its exact CUDA device name. A device whose
peak is not in the table (the CPU, another card, another H100 part) returns
None — an "MFU" against
an unknown peak would be noise, so the gauge is simply omitted there.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

# peak dense bf16 FLOP/s by torch.cuda.get_device_name(): NVIDIA's data
# sheets, without sparsity, at the full power limit. Only the SXM part: the
# H100 PCIe and NVL have lower peaks under names that also hold "H100"
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}


def param_count(module_or_params) -> int:
    """Total parameter count of an ``nn.Module``, or of a mapping or
    iterable of tensors (a ``state_dict``, ``named_parameters()`` values)."""
    if isinstance(module_or_params, torch.nn.Module):
        tensors = module_or_params.parameters()
    elif isinstance(module_or_params, dict):
        tensors = module_or_params.values()
    else:
        tensors = module_or_params
    return int(sum(t.numel() for t in tensors))


def flops_per_token(n_params: int) -> float:
    """Training (fwd+bwd) matmul FLOPs per token, the standard 6N estimate."""
    return 6.0 * float(n_params)


def device_peak_flops(device: Any) -> Optional[float]:
    """Peak dense bf16 FLOP/s of a CUDA device, or None when unknown (the
    CPU, or a card not in :data:`PEAK_BF16_FLOPS`)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(device))


def estimate_mfu(tok_per_sec: float, n_params: int, devices) -> Optional[float]:
    """Achieved/peak FLOPs fraction for a whole device set, or None where a
    peak is unknown."""
    if not devices or tok_per_sec <= 0 or n_params <= 0:
        return None
    peak = device_peak_flops(devices[0])
    if peak is None:
        return None
    achieved = tok_per_sec * flops_per_token(n_params)
    return achieved / (peak * len(devices))
