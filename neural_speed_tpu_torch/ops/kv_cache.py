"""KV cache (port of `neural_speed_tpu/ops/kv_cache.py`, contiguous slots).

Layouts as in the JAX package: `[L, B, H_kv, S, D]` of the cache dtype
(bf16 by default, as the JAX `init_cache`), or, quantized, int8 codes with
per-(token, head) scales `[L, B, H_kv, S]`, bf16 by default or float32
(`scale_dtype`, or `NST_KV_SCALE_DTYPE=f32`).  Codes are always computed
against the float32 scale; only the stored scale rounds, in every writer
(the appends here and in `paged_kv.py`, and the decode kernels' fused
append), so caches stay bit-identical across paths.

JAX's functional updates with buffer donation become in-place writes here:
`append_layer` and `set_lengths` mutate the cache they are given and
return it; `reorder` (beam search) gathers into a new cache.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch

KV_SCALE_EPS = 1e-8


@dataclasses.dataclass
class KVCache:
    """k, v: [L, B, H_kv, S, D] (int8 codes when quantized); k_scale,
    v_scale: [L, B, H_kv, S] bf16 or float32 when quantized, else None;
    lengths: [B] int32 tokens stored per slot."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    lengths: torch.Tensor

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def kv_scale_dtype(scale_dtype=None) -> torch.dtype:
    """The scale dtype of a quantized cache: `scale_dtype` when given, else
    float32 when `NST_KV_SCALE_DTYPE` is `f32` or `float32`, else bf16 (the
    JAX package's rule, read when the cache is built)."""
    if scale_dtype is not None:
        if scale_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"KV scales are bf16 or float32, got "
                             f"{scale_dtype}")
        return scale_dtype
    env = os.environ.get("NST_KV_SCALE_DTYPE", "bf16")
    return torch.float32 if env in ("f32", "float32") else torch.bfloat16


def init_cache(layers: int, batch: int, max_len: int, kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, quantized: bool = False,
               device=None, scale_dtype=None) -> KVCache:
    """Zeroed cache on `device` (the card unless the CPU is asked for):
    `dtype` values (bf16 by default, or float32, the JAX package's
    `memory_dtype="f32"`), or with `quantized` int8 codes and scales of
    `kv_scale_dtype(scale_dtype)`."""
    from .._build import resolve_device

    dev = resolve_device(device)
    shape = (layers, batch, kv_heads, max_len, head_dim)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if not quantized:
        return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros(shape, dtype=dtype, device=dev), None,
                       None, lengths)
    sdt = kv_scale_dtype(scale_dtype)
    return KVCache(
        torch.zeros(shape, dtype=torch.int8, device=dev),
        torch.zeros(shape, dtype=torch.int8, device=dev),
        torch.zeros(shape[:-1], dtype=sdt, device=dev),
        torch.zeros(shape[:-1], dtype=sdt, device=dev), lengths)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8: x [..., D] -> codes, f32 scale
    [..., 1].  `scale = amax / 127` is a division and the codes round half
    to even, exactly as the JAX package and the decode kernel do."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(KV_SCALE_EPS)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by the reciprocal, which can differ in the last bit
    scale = amax / torch.full_like(amax, 127.0)
    codes = torch.clamp(torch.round(xf / scale), -127, 127)
    return codes.to(torch.int8), scale


def _write_rows(dst: torch.Tensor, layer: int, rows: torch.Tensor,
                upd: torch.Tensor, keep: torch.Tensor) -> None:
    """dst[layer, b, :, rows[b, i]] = upd[b, :, i] where keep[b, i], in place.
    dst: [L, B, H, S(, D)]; rows/keep: [B, T]; upd: [B, H, T(, D)]."""
    d = dst[layer]
    extra = d.shape[3:]
    b, h = d.shape[0], d.shape[1]
    idx = rows[:, None, :].expand(b, h, rows.shape[1])
    idx = idx.reshape(b, h, -1, *([1] * len(extra))).expand(
        b, h, rows.shape[1], *extra).long()
    cur = torch.gather(d, 2, idx)
    sel = keep[:, None, :].reshape(b, 1, -1, *([1] * len(extra)))
    d.scatter_(2, idx, torch.where(sel, upd.to(d.dtype), cur))


def append_layer(cache: KVCache, layer: int, k_new: torch.Tensor,
                 v_new: torch.Tensor, positions: torch.Tensor,
                 active: Optional[torch.Tensor] = None) -> KVCache:
    """Write `[B, T, H, D]` keys/values at `positions [B, T]`, in place.

    T > 1 (prefill): each active slot's whole T-row window is written from
    `positions[:, 0]`, padding rows included (attention masks them by
    kv_len).  A window that would overhang the cache end is clipped down and
    rolled so the real rows still land at the true start while the rows
    below it keep their contents.  T == 1 (decode): one row at the clipped
    position.  Inactive slots are left untouched.  A quantized cache takes
    the int8 codes and scales of `quantize_kv`, a float cache the values
    cast to its dtype."""
    b, t = positions.shape
    dev = positions.device
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=dev)
    ar = torch.arange(t, device=dev)
    if t == 1:
        rows = positions[:, :1].clamp(0, cache.max_len - 1)
        keep = active[:, None]
        src = ar[None, :].expand(b, t)
    else:
        start_true = positions[:, 0].clamp_min(0)
        start = positions[:, 0].clamp(0, cache.max_len - t)
        shift = start_true - start
        rows = start[:, None] + ar[None, :]
        keep = active[:, None] & (ar[None, :] >= shift[:, None])
        src = (ar[None, :] - shift[:, None]).clamp_min(0)
    kt = k_new.transpose(1, 2)                               # [B, H, T, D]
    vt = v_new.transpose(1, 2)
    gather_t = lambda a: torch.gather(
        a, 2, src[:, None, :, None].expand(-1, a.shape[1], -1, a.shape[3]))
    if not cache.quantized:
        _write_rows(cache.k, layer, rows, gather_t(kt), keep)
        _write_rows(cache.v, layer, rows, gather_t(vt), keep)
        return cache
    kc, ks = quantize_kv(kt)
    vc, vs = quantize_kv(vt)
    kc, ks, vc, vs = gather_t(kc), gather_t(ks), gather_t(vc), gather_t(vs)
    _write_rows(cache.k, layer, rows, kc, keep)
    _write_rows(cache.v, layer, rows, vc, keep)
    _write_rows(cache.k_scale, layer, rows, ks[..., 0], keep)
    _write_rows(cache.v_scale, layer, rows, vs[..., 0], keep)
    return cache


def set_lengths(cache: KVCache, lengths: torch.Tensor) -> KVCache:
    """Set the stored lengths, in place."""
    cache.lengths = lengths.to(torch.int32)
    return cache


def reorder(cache: KVCache, src_slots: torch.Tensor) -> KVCache:
    """Beam-search KV reorder: new slot b takes old slot src_slots[b], a
    gather over the slot axis of every tensor and of the lengths.  Returns a
    new cache, as the JAX function does; the old one is left as it was."""
    idx = src_slots.to(device=cache.k.device, dtype=torch.long)
    take = lambda a: None if a is None else a.index_select(1, idx)
    return KVCache(take(cache.k), take(cache.v), take(cache.k_scale),
                   take(cache.v_scale), cache.lengths.index_select(0, idx))
