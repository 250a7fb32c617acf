"""Normalization (port of `neural_speed_tpu/ops/norms.py`): plain torch."""

from __future__ import annotations

from typing import Optional

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


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], eps: float = 1e-5
               ) -> torch.Tensor:
    """LayerNorm (gptj / gptneox / opt / bloom / mpt / falcon ...) with the
    statistics in float32; `bias` None for MPT's bias-free norms."""
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(dt)


def gemma_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Gemma's (1 + w) RMSNorm convention."""
    return rms_norm(x, weight + 1.0, eps)
