"""Attention over one layer of the KV cache (port of
`neural_speed_tpu/ops/attention.py::attention_cache`, over the contiguous
int8 cache and the paged int8 pool).

The flash route (`flash.mha`) is the default on both devices.
`use_flash=False`, or extra k/v that the decode kernel cannot take, asks for
`_attention_ref_hsd`, the JAX package's XLA reference math (float32
throughout over the dequantized cache).  That reference is a plain version
with no kernel behind it, so it runs on CPU tensors only and raises on the
card.  Over a `PagedKVCache` the flash route is `flash.mha_paged`, and the
reference route reads the layer gathered through the page tables.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import _build
from . import flash
from . import paged_kv as pkv

NEG_INF = -1e9


def attention_cache(q: torch.Tensor, cache, layer_idx: int,
                    q_positions: torch.Tensor, kv_lens: torch.Tensor, *,
                    scale: Optional[float] = None, causal: bool = True,
                    out_dtype=None, use_flash: bool = True, extra_kv=None,
                    fused_append: bool = False):
    """q [B, T, H, D] over layer `layer_idx` of the int8 cache or page
    pool.  With `fused_append` returns (out, cache) — the cache written in
    place — or None when the decode kernel cannot take the call."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out_dtype = out_dtype or q.dtype
    if isinstance(cache, pkv.PagedKVCache):
        return _attention_paged(q, cache, layer_idx, q_positions, kv_lens,
                                scale, causal, out_dtype, use_flash,
                                fused_append, extra_kv)
    if fused_append:
        if extra_kv is None or not use_flash:
            return None
        res = flash.mha(q, cache.k, cache.v, cache.k_scale, cache.v_scale,
                        q_positions, kv_lens, scale=scale, causal=causal,
                        out_dtype=out_dtype, layer=layer_idx,
                        extra_kv=extra_kv, fused_append=True)
        if res is None:
            return None
        return res[0], cache
    if use_flash:
        out = flash.mha(q, cache.k, cache.v, cache.k_scale, cache.v_scale,
                        q_positions, kv_lens, scale=scale, causal=causal,
                        out_dtype=out_dtype, layer=layer_idx,
                        extra_kv=extra_kv)
        if out is not None:
            return out
    if q.device.type != "cpu":
        raise ValueError(
            f"attention_cache: the float32 reference route (use_flash="
            f"{use_flash}, extra_kv for {q.shape[1]} tokens and "
            f"{q.shape[2] // cache.k.shape[2]} query heads per KV head) has no "
            f"kernel; it runs on CPU tensors only, got q on {q.device}")
    _build.plain_dispatches["attention_ref"] += 1
    k_all = cache.k[layer_idx].float() * cache.k_scale[layer_idx].float()[..., None]
    v_all = cache.v[layer_idx].float() * cache.v_scale[layer_idx].float()[..., None]
    if extra_kv is not None:
        # the current token's k/v merged at its position (append-then-read
        # semantics with float operands)
        k_new, v_new = extra_kv                               # [B, 1, Hkv, D]
        p = q_positions[:, 0].clamp_max(k_all.shape[2] - 1)
        oh = torch.nn.functional.one_hot(p.long(), k_all.shape[2]).float()
        oh = oh[:, None, :, None]
        k_all = k_all * (1.0 - oh) + oh * k_new.transpose(1, 2).float()
        v_all = v_all * (1.0 - oh) + oh * v_new.transpose(1, 2).float()
    return _attention_ref_hsd(q, k_all, v_all, q_positions, kv_lens,
                              scale=scale, causal=causal, out_dtype=out_dtype)


def _attention_paged(q, cache, layer_idx, q_positions, kv_lens, scale, causal,
                     out_dtype, use_flash, fused_append, extra_kv):
    """The `PagedKVCache` branch of `attention_cache`."""
    if fused_append:
        if not use_flash:
            return None
        res = flash.mha_paged(q, cache, layer_idx, q_positions, kv_lens,
                              scale=scale, causal=causal, out_dtype=out_dtype,
                              extra_kv=extra_kv, fused_append=True)
        return None if res is None else (res[0], cache)
    if use_flash:
        return flash.mha_paged(q, cache, layer_idx, q_positions, kv_lens,
                               scale=scale, causal=causal,
                               out_dtype=out_dtype)
    if q.device.type != "cpu":
        raise ValueError(
            f"attention_cache: the float32 reference route over the page "
            f"pool (use_flash=False) has no kernel; it runs on CPU tensors "
            f"only, got q on {q.device}")
    _build.plain_dispatches["attention_ref"] += 1
    k_all, v_all = pkv.gathered_layer(cache, layer_idx, torch.float32)
    return _attention_ref_hsd(q, k_all, v_all, q_positions, kv_lens,
                              scale=scale, causal=causal, out_dtype=out_dtype)


def _attention_ref_hsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_positions: torch.Tensor, kv_lens: torch.Tensor,
                       scale: Optional[float] = None, causal: bool = True,
                       out_dtype=None) -> torch.Tensor:
    """Reference attention: q [B, T, H, D], k/v [B, Hkv, S, D] float."""
    b, t, h, d = q.shape
    h_kv, s = k.shape[1], k.shape[2]
    n_rep = h // h_kv
    out_dtype = out_dtype or q.dtype
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf = torch.repeat_interleave(k.float(), n_rep, dim=1)
    vf = torch.repeat_interleave(v.float(), n_rep, dim=1)
    qf = q.float() * scale
    logits = torch.einsum("bthd,bhsd->bhts", qf, kf)
    kpos = torch.arange(s, device=q.device)[None, None, :]
    valid = kpos < kv_lens[:, None, None]
    if causal:
        valid = valid & (kpos <= q_positions[:, :, None])
    else:
        valid = valid.expand(b, t, s)
    # a large negative value instead of -inf keeps fully masked rows NaN-free
    logits = torch.where(valid[:, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bhsd->bthd", probs, vf)
    return out.to(out_dtype)
