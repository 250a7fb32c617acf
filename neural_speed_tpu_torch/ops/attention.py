"""Attention (port of `neural_speed_tpu/ops/attention.py`): ALiBi slopes,
the reference masked softmax `attention_ref`, the dispatch `attention` over
float K/V, and `attention_cache` over one layer of the contiguous cache or
the page pool, int8 or bf16.

The flash route (`flash.mha` / `flash.mha_paged`) is the default on both
devices.  `use_flash=False`, or extra k/v that the decode kernel cannot
take, asks for `_attention_ref_hsd`, the JAX package's XLA reference math
(float32 throughout over the dequantized cache).  That reference is a plain
version with no kernel behind it, so it runs on CPU tensors only and raises
on the card.  Over a `PagedKVCache` the flash route is `flash.mha_paged`,
and the reference route reads the layer gathered through the page tables.
Over a bf16 cache decode appends first, then attends (the JAX package's
deferred append needs the quantized cache).  The JAX package sends MHA bf16
decode to XLA; the port, which has no XLA, sends it to kernel B's bf16
instance on the card and to that kernel's plain version on the CPU.  Float
K/V `[B, S, Hkv, D]` go to the kernels laid out as a one-layer stacked
cache (`kv_layout`: `[1, B, Hkv, S_pad, D]`, S_pad the next multiple of 64,
the padding masked by the lengths), so whisper's 1500 frames, which the JAX
package leaves to XLA (`flash._supported` asks for S % 128 == 0), reach
kernels C and B.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from .. import _build
from . import flash
from . import paged_kv as pkv

NEG_INF = -1e9
KV_ROWS = 64        # the attention kernels take caches of S % 64 == 0 rows


def kv_layout(x: torch.Tensor, out: Optional[torch.Tensor] = None,
              layer: int = 0, layers: int = 1) -> torch.Tensor:
    """Float K or V `[B, S, Hkv, D]` in the attention kernels' layout: layer
    `layer` of a stacked cache `[layers, B, Hkv, S_pad, D]` with S_pad the
    next multiple of 64 (zero rows past S, which the lengths mask), written
    into `out` when given, else into a new stack.  Returns the stack."""
    b, s, h, d = x.shape
    if out is None:
        s_pad = -(-s // KV_ROWS) * KV_ROWS
        out = x.new_zeros((layers, b, h, s_pad, d))
    out[layer, :, :, :s] = x.transpose(1, 2)
    return out


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """The ALiBi slope schedule (float32 [H]): a geometric series for a
    power-of-two head count, else the next lower power's series followed by
    every other slope of twice that count's.  Cached per head count and
    device (`forward` asks once per step, and building a tensor from host
    values synchronises the card): callers must not write to it."""
    return _alibi_slopes(n_heads, str(torch.device(device or "cpu")))


@functools.lru_cache(maxsize=16)
def _alibi_slopes(n_heads: int, device: str) -> torch.Tensor:
    def pow2slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        vals = pow2slopes(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        vals = (pow2slopes(closest)
                + pow2slopes(2 * closest)[0::2][: n_heads - closest])
    return torch.tensor(vals, dtype=torch.float32, device=device)


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(logits / cap) if cap > 0.0 else logits


def _masked_softmax_pv(logits: torch.Tensor, valid: torch.Tensor,
                       vf: torch.Tensor, eq: str) -> torch.Tensor:
    # a large negative value instead of -inf keeps fully masked rows NaN-free
    logits = torch.where(valid[:, None], logits,
                         logits.new_full((), NEG_INF))
    return torch.einsum(eq, torch.softmax(logits, dim=-1), vf)


def _alibi_bias(logits, alibi, q_positions, s: int):
    kpos = torch.arange(s, device=logits.device)
    dist = kpos.float()[None, None] - q_positions.float()[:, :, None]
    return logits + alibi.float()[None, :, None, None] * dist[:, None]


def _valid(q_positions, kv_lens, s: int, causal: bool, t: int):
    kpos = torch.arange(s, device=q_positions.device)[None, None, :]
    valid = kpos < kv_lens[:, None, None]
    if causal:
        return valid & (kpos <= q_positions[:, :, None])
    return valid.expand(q_positions.shape[0], t, s)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_positions: torch.Tensor, kv_lens: torch.Tensor,
                  scale: Optional[float] = None, causal: bool = True,
                  alibi: Optional[torch.Tensor] = None,
                  logit_softcap: float = 0.0, out_dtype=None) -> torch.Tensor:
    """Masked softmax attention in float32: q [B, T, H, D], k/v
    [B, S, H_kv, D], positions [B, T], kv lengths [B], ALiBi slopes [H] or
    None, and grok's `softcap * tanh(logits / softcap)`."""
    b, t, h, d = q.shape
    s, h_kv = k.shape[1], k.shape[2]
    n_rep = h // h_kv
    out_dtype = out_dtype or q.dtype
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf = torch.repeat_interleave(k.float(), n_rep, dim=2)
    vf = torch.repeat_interleave(v.float(), n_rep, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", q.float() * scale, kf)
    logits = _softcap(logits, logit_softcap)
    if alibi is not None:
        logits = _alibi_bias(logits, alibi, q_positions, s)
    valid = _valid(q_positions, kv_lens, s, causal, t)
    return _masked_softmax_pv(logits, valid, vf,
                              "bhts,bshd->bthd").to(out_dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_positions: torch.Tensor, kv_lens: torch.Tensor, *,
              scale: Optional[float] = None, causal: bool = True,
              alibi: Optional[torch.Tensor] = None,
              logit_softcap: float = 0.0, out_dtype=None,
              use_flash: bool = True) -> torch.Tensor:
    """Attention over float K/V `[B, S, H_kv, D]`, causal or not: the flash
    kernels over K/V in `kv_layout` (their plain versions for CPU tensors;
    lengths past S are clipped to S, as the reference masks only the S
    columns it has), or with `use_flash=False` `attention_ref`, which runs
    on CPU tensors only."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if use_flash:
        s = k.shape[1]
        kt, vt = kv_layout(k), kv_layout(v)            # [1, B, Hkv, S_pad, D]
        if kt.shape[3] != s:
            kv_lens = kv_lens.clamp_max(s)
        return flash.mha(q, kt, vt, None, None, q_positions, kv_lens,
                         scale=scale, causal=causal, alibi=alibi,
                         logit_softcap=logit_softcap, out_dtype=out_dtype,
                         layer=0)
    if q.device.type != "cpu":
        raise ValueError(f"attention: the float32 reference route has no "
                         f"kernel; it runs on CPU tensors only, got q on "
                         f"{q.device}")
    _build.plain_dispatches["attention_ref"] += 1
    return attention_ref(q, k, v, q_positions, kv_lens, scale=scale,
                         causal=causal, alibi=alibi,
                         logit_softcap=logit_softcap, out_dtype=out_dtype)


def attention_cache(q: torch.Tensor, cache, layer_idx: int,
                    q_positions: torch.Tensor, kv_lens: torch.Tensor, *,
                    scale: Optional[float] = None, causal: bool = True,
                    alibi: Optional[torch.Tensor] = None,
                    logit_softcap: float = 0.0, out_dtype=None,
                    use_flash: bool = True, extra_kv=None,
                    fused_append: bool = False):
    """q [B, T, H, D] over layer `layer_idx` of the cache or page pool
    (int8 or bf16).  With `fused_append` returns (out, cache) — the cache
    written in place — or None when the decode kernel cannot take the call
    (always over a bf16 cache)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out_dtype = out_dtype or q.dtype
    kw = dict(scale=scale, causal=causal, alibi=alibi,
              logit_softcap=logit_softcap, out_dtype=out_dtype)
    if isinstance(cache, pkv.PagedKVCache):
        return _attention_paged(q, cache, layer_idx, q_positions, kv_lens,
                                use_flash, fused_append, extra_kv, kw)
    ks, vs = cache.k_scale, cache.v_scale
    if fused_append:
        if extra_kv is None or not use_flash or not cache.quantized:
            return None
        res = flash.mha(q, cache.k, cache.v, ks, vs, q_positions, kv_lens,
                        layer=layer_idx, extra_kv=extra_kv,
                        fused_append=True, **kw)
        if res is None:
            return None
        return res[0], cache
    if use_flash:
        out = flash.mha(q, cache.k, cache.v, ks, vs, q_positions, kv_lens,
                        layer=layer_idx, extra_kv=extra_kv, **kw)
        if out is not None:
            return out
    if q.device.type != "cpu":
        raise ValueError(
            f"attention_cache: the float32 reference route (use_flash="
            f"{use_flash}, extra_kv for {q.shape[1]} tokens and "
            f"{q.shape[2] // cache.k.shape[2]} query heads per KV head) has no "
            f"kernel; it runs on CPU tensors only, got q on {q.device}")
    _build.plain_dispatches["attention_ref"] += 1
    k_all = cache.k[layer_idx].float()
    v_all = cache.v[layer_idx].float()
    if cache.quantized:
        k_all = k_all * ks[layer_idx].float()[..., None]
        v_all = v_all * vs[layer_idx].float()[..., None]
    if extra_kv is not None:
        # the current token's k/v merged at its position (append-then-read
        # semantics with float operands)
        k_new, v_new = extra_kv                               # [B, 1, Hkv, D]
        p = q_positions[:, 0].clamp_max(k_all.shape[2] - 1)
        oh = torch.nn.functional.one_hot(p.long(), k_all.shape[2]).float()
        oh = oh[:, None, :, None]
        k_all = k_all * (1.0 - oh) + oh * k_new.transpose(1, 2).float()
        v_all = v_all * (1.0 - oh) + oh * v_new.transpose(1, 2).float()
    return _attention_ref_hsd(q, k_all, v_all, q_positions, kv_lens, **kw)


def _attention_paged(q, cache, layer_idx, q_positions, kv_lens, use_flash,
                     fused_append, extra_kv, kw):
    """The `PagedKVCache` branch of `attention_cache`."""
    if fused_append:
        if not use_flash or not cache.quantized:
            return None
        res = flash.mha_paged(q, cache, layer_idx, q_positions, kv_lens,
                              extra_kv=extra_kv, fused_append=True, **kw)
        return None if res is None else (res[0], cache)
    if use_flash:
        return flash.mha_paged(q, cache, layer_idx, q_positions, kv_lens,
                               **kw)
    if q.device.type != "cpu":
        raise ValueError(
            f"attention_cache: the float32 reference route over the page "
            f"pool (use_flash=False) has no kernel; it runs on CPU tensors "
            f"only, got q on {q.device}")
    _build.plain_dispatches["attention_ref"] += 1
    k_all, v_all = pkv.gathered_layer(cache, layer_idx, torch.float32)
    return _attention_ref_hsd(q, k_all, v_all, q_positions, kv_lens, **kw)


def _attention_ref_hsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_positions: torch.Tensor, kv_lens: torch.Tensor,
                       scale: Optional[float] = None, causal: bool = True,
                       alibi: Optional[torch.Tensor] = None,
                       logit_softcap: float = 0.0,
                       out_dtype=None) -> torch.Tensor:
    """Reference attention: q [B, T, H, D], k/v [B, Hkv, S, D] float."""
    b, t, h, d = q.shape
    h_kv, s = k.shape[1], k.shape[2]
    n_rep = h // h_kv
    out_dtype = out_dtype or q.dtype
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf = torch.repeat_interleave(k.float(), n_rep, dim=1)
    vf = torch.repeat_interleave(v.float(), n_rep, dim=1)
    logits = torch.einsum("bthd,bhsd->bhts", q.float() * scale, kf)
    logits = _softcap(logits, logit_softcap)
    if alibi is not None:
        logits = _alibi_bias(logits, alibi, q_positions, s)
    valid = _valid(q_positions, kv_lens, s, causal, t)
    return _masked_softmax_pv(logits, valid, vf,
                              "bhts,bhsd->bthd").to(out_dtype)
