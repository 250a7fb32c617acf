"""Normalization (port of `neural_speed_tpu/ops/norms.py`): plain torch."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             upcast: bool = True) -> torch.Tensor:
    """RMSNorm (llama family) with the statistics in float32."""
    dt = x.dtype
    if upcast:
        x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * weight.to(out.dtype)).to(dt)
