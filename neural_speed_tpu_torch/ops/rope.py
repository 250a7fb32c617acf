"""Rotary position embeddings (port of `neural_speed_tpu/ops/rope.py`).

Position-explicit: positions are passed per token because continuous
batching mixes sequences at unrelated offsets.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Frequency scaling config (linear / NTK / YaRN / LongRoPE)."""

    kind: str = "none"  # none | linear | ntk | yarn | longrope
    factor: float = 1.0
    original_max_position: int = 2048
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    attn_factor: float = 1.0
    long_factors: Optional[Tuple[float, ...]] = None
    short_factors: Optional[Tuple[float, ...]] = None


def _yarn_find_correction_dim(num_rot: float, dim: int, base: float,
                              max_pos: int) -> float:
    return (dim * math.log(max_pos / (num_rot * 2 * math.pi))) / (
        2 * math.log(base))


def rope_inv_freq(rot_dim: int, base: float = 10000.0,
                  scaling: Optional[RopeScaling] = None,
                  seq_len: Optional[int] = None,
                  device=None) -> Tuple[torch.Tensor, float]:
    """Per-dim inverse frequencies (float32) + attention magnitude scale.
    Cached per arguments and device (`forward` asks once per step): the
    returned tensor is shared, so callers must not write to it."""
    return _rope_inv_freq(rot_dim, float(base), scaling, seq_len,
                          str(torch.device(device or "cpu")))


@functools.lru_cache(maxsize=64)
def _rope_inv_freq(rot_dim: int, base: float, scaling: Optional[RopeScaling],
                   seq_len: Optional[int],
                   device: str) -> Tuple[torch.Tensor, float]:
    half = rot_dim // 2
    exponents = torch.arange(0, half, dtype=torch.float32, device=device) / half
    inv = 1.0 / (exponents.new_full((), base) ** exponents)
    s = scaling
    if s is None or s.kind == "none":
        return inv, 1.0
    if s.kind == "linear":
        return inv / s.factor, 1.0
    if s.kind == "ntk":
        base2 = base * (s.factor ** (rot_dim / (rot_dim - 2)))
        return 1.0 / (exponents.new_full((), base2) ** exponents), 1.0
    if s.kind == "yarn":
        lo = _yarn_find_correction_dim(s.beta_fast, rot_dim, base,
                                       s.original_max_position)
        hi = _yarn_find_correction_dim(s.beta_slow, rot_dim, base,
                                       s.original_max_position)
        lo, hi = max(math.floor(lo), 0), min(math.ceil(hi), half - 1)
        ramp = torch.clamp(
            (torch.arange(half, dtype=torch.float32, device=device) - lo)
            / max(hi - lo, 1e-3), 0, 1)
        mask = 1.0 - ramp  # 1 => extrapolate (keep inv)
        out = (inv / s.factor) * (1 - mask) + inv * mask
        return out, (0.1 * math.log(s.factor) + 1.0) * s.attn_factor
    if s.kind == "longrope":
        use_long = seq_len is not None and seq_len > s.original_max_position
        factors = s.long_factors if use_long else s.short_factors
        f = torch.tensor(factors, dtype=torch.float32, device=device)
        mscale = 1.0
        if s.factor > 1.0:
            mscale = math.sqrt(
                1 + math.log(s.factor) / math.log(s.original_max_position))
        return inv / f, mscale
    raise ValueError(f"unknown rope scaling {s.kind}")


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor,
                 mscale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...] int -> float32 cos/sin [..., half]."""
    ang = positions[..., None].float() * inv_freq
    return torch.cos(ang) * mscale, torch.sin(ang) * mscale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               style: str = "neox", rot_dim: Optional[int] = None
               ) -> torch.Tensor:
    """Rotate the first `rot_dim` features of x [..., T, H, D]; cos/sin are
    [..., T, half].  The math runs in float32, the result takes x's dtype."""
    d = x.shape[-1]
    rd = rot_dim or d
    half = rd // 2
    xr, xp = x[..., :rd].float(), x[..., rd:]
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    if style == "neox":
        x1, x2 = xr[..., :half], xr[..., half:]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    elif style == "gptj":
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                          dim=-1).reshape(xr.shape)
    else:
        raise ValueError(f"unknown rope style {style}")
    out = out.to(x.dtype)
    if rd < d:
        out = torch.cat([out, xp], dim=-1)
    return out
