"""Decoder forward (port of the llama path of `neural_speed_tpu/models/transformer.py`).

Params are a plain dict; linear leaves are a `QTensor` (int-packed, fed to
`qmatmul`) or a dense `[K, N]` tensor.  Positions and per-slot kv lengths
are explicit, as in the JAX package, so continuous batching can mix slots
at unrelated offsets.  The KV cache (contiguous `KVCache` or paged
`PagedKVCache`) is written in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops import kv_cache as kvc
from ..ops import flash
from ..ops import paged_kv as pkv
from ..ops.attention import attention_cache
from ..ops.matmul import kernel_k_multiple, qmatmul, qmatmul_int8
from ..ops.norms import rms_norm
from ..ops.quantize import QTensor, concat_n, repad_k
from ..ops.rope import apply_rope, rope_cos_sin, rope_inv_freq
from .arch import ArchConfig

Params = Dict[str, Any]


def check_supported(cfg: ArchConfig) -> None:
    """Raise for configurations outside the ported llama path."""
    unsupported = {
        "moe": cfg.moe is not None, "norm": cfg.norm != "rms",
        "gemma_norm": cfg.gemma_norm, "embedding_ln": cfg.embedding_ln,
        "post_attn_norm": cfg.post_attn_norm,
        "post_ffn_norm": cfg.post_ffn_norm, "clip_qkv": bool(cfg.clip_qkv),
        "use_alibi": cfg.use_alibi, "logit_softcap": bool(cfg.logit_softcap),
        "logn_attn": cfg.logn_attn,
        "rope_style": cfg.rope_style not in ("neox", "gptj"),
        "learned_pos": cfg.learned_pos, "gated_ffn": not cfg.gated_ffn,
        "act": cfg.act != "silu", "parallel_residual": cfg.parallel_residual,
        "deepnorm_alpha": cfg.deepnorm_alpha is not None,
        "embed_scale": cfg.embed_scale != 1.0,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {bad}")


COMP_MODES = (None, "int8", "int8t")
INT8_MIN_ROWS = 32


def linear(x: torch.Tensor, p: Params,
           comp: Optional[str] = None) -> torch.Tensor:
    """p = {"w": QTensor | [K, N] tensor, "b": optional [N]}; output in x's
    dtype (dense weights: float32 accumulation, then the cast).  `comp`
    "int8" / "int8t" (one activation scale per token) sends steps of at
    least 32 rows through `qmatmul_int8`; decode stays on the weight-only
    path, where activation quantization would add error and save no bytes."""
    w = p["w"]
    if isinstance(w, QTensor):
        if comp is not None and x.numel() // x.shape[-1] >= INT8_MIN_ROWS:
            out = qmatmul_int8(x, w, per_token=comp == "int8t")
        else:
            out = qmatmul(x, w)
    else:
        out = (x.float() @ w.to(x.dtype).float()).to(x.dtype)
    b = p.get("b")
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def norm(x: torch.Tensor, p: Params, cfg: ArchConfig) -> torch.Tensor:
    return rms_norm(x, p["weight"], cfg.norm_eps)


def ffn(x: torch.Tensor, p: Params, cfg: ArchConfig,
        comp: Optional[str] = None) -> torch.Tensor:
    """Gated SiLU MLP; fused gate+up when `fuse_params` made one."""
    if "gateup" in p:
        gate, up = torch.chunk(linear(x, p["gateup"], comp), 2, dim=-1)
    else:
        gate, up = linear(x, p["gate"], comp), linear(x, p["up"], comp)
    return linear(torch.nn.functional.silu(gate) * up, p["down"], comp)


def kv_append_mode(cfg: ArchConfig) -> str:
    """The decode KV-append path: "plain" (append, then attend) when pinned,
    else "fused" (the decode kernel attends and writes the new row; its plain
    version always exists in the port, so the JAX package's `flash_enabled`
    condition is dropped).  The JAX package's "defer" is not ported."""
    mode = "fused" if cfg.kv_append == "env" else cfg.kv_append
    if mode not in ("plain", "fused"):
        raise NotImplementedError(f"kv_append={mode!r} is not ported")
    return mode


def _defer_append(cfg: ArchConfig, t: int) -> bool:
    """Single-token decode with the current k/v as attention operands.  The
    JAX package defers on a paged cache only in "fused" mode; the port has
    no other deferring mode, so the rule is the same for both caches."""
    return (kv_append_mode(cfg) == "fused"
            and flash.extra_kv_eligible(t, cfg.n_heads, cfg.n_kv_heads))


def _cache_append(cache, layer_idx: int, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, active: torch.Tensor):
    """KV append by cache type, in place: on the page pool one token per
    slot goes through `append_decode` and longer spans through
    `append_span`, which resolves every row through the table and parks
    padding on the trash page."""
    if isinstance(cache, pkv.PagedKVCache):
        if positions.shape[1] == 1:
            return pkv.append_decode(cache, layer_idx, k, v, positions,
                                     active)
        return pkv.append_span(cache, layer_idx, k, v, positions,
                               active=active)
    return kvc.append_layer(cache, layer_idx, k, v, positions, active=active)


def decoder_layer(x: torch.Tensor, lp: Params, cfg: ArchConfig,
                  layer_idx: int, cache: kvc.KVCache,
                  positions: torch.Tensor, kv_lens: torch.Tensor,
                  cos: torch.Tensor, sin: torch.Tensor,
                  comp: Optional[str] = None
                  ) -> Tuple[torch.Tensor, kvc.KVCache]:
    b, t, _ = x.shape
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    attn_in = norm(x, lp["attn_norm"], cfg)
    if "qkv" in lp:
        q, k, v = torch.split(linear(attn_in, lp["qkv"], comp),
                              [h * d, hkv * d, hkv * d], dim=-1)
    else:
        q, k, v = (linear(attn_in, lp[n], comp) for n in ("q", "k", "v"))
    q = apply_rope(q.reshape(b, t, h, d), cos, sin, cfg.rope_style,
                   cfg.rot_dim)
    k = apply_rope(k.reshape(b, t, hkv, d), cos, sin, cfg.rope_style,
                   cfg.rot_dim)
    v = v.reshape(b, t, hkv, d)

    # active slots are those whose kv_lens advance past their first written
    # position (spectator slots keep kv_lens == old length)
    active = kv_lens > positions[:, 0]
    attn_kwargs = dict(scale=cfg.attn_scale if cfg.attn_scale is not None
                       else 1.0 / math.sqrt(d), causal=True, out_dtype=x.dtype)
    fused = None
    if _defer_append(cfg, t):
        fused = attention_cache(q, cache, layer_idx, positions, kv_lens,
                                extra_kv=(k, v), fused_append=True,
                                **attn_kwargs)
    if fused is not None:
        attn_out, cache = fused
    else:
        cache = _cache_append(cache, layer_idx, k, v, positions, active)
        attn_out = attention_cache(q, cache, layer_idx, positions, kv_lens,
                                   **attn_kwargs)
    h1 = x + linear(attn_out.reshape(b, t, h * d), lp["o"], comp)
    return (h1 + ffn(norm(h1, lp["ffn_norm"], cfg), lp["ffn"], cfg, comp),
            cache)


def forward(params: Params, cfg: ArchConfig, token_ids: torch.Tensor,
            positions: torch.Tensor, cache: kvc.KVCache,
            kv_lens: torch.Tensor,
            logits_positions: Optional[torch.Tensor] = None,
            comp: Optional[str] = None
            ) -> Tuple[torch.Tensor, kvc.KVCache]:
    """Embed `token_ids [B, T]`, run every layer (appending to `cache` in
    place) and return float32 logits `[B, T, vocab]`, or `[B, R, vocab]` at
    the rows `logits_positions [B, R]` only (the LM head is then a GEMV).
    `comp`: the int8-compute switch of `linear`."""
    check_supported(cfg)
    if comp not in COMP_MODES:
        raise ValueError(f"comp must be one of {COMP_MODES}, got {comp!r}")
    x = params["embed"]["weight"][token_ids]
    rot = cfg.rot_dim or cfg.head_dim
    inv_freq, mscale = rope_inv_freq(rot, cfg.rope_base, cfg.rope_scaling,
                                     seq_len=cache.max_len, device=x.device)
    cos, sin = rope_cos_sin(positions, inv_freq, mscale)
    for i, lp in enumerate(params["layers"]):
        x, cache = decoder_layer(x, lp, cfg, i, cache, positions, kv_lens,
                                 cos, sin, comp)
    if logits_positions is not None:
        idx = logits_positions[:, :, None].expand(-1, -1, x.shape[-1])
        x = torch.gather(x, 1, idx.long())
    if cfg.final_norm:
        x = norm(x, params["final_norm"], cfg)
    head = params.get("lm_head")
    if head is None or cfg.tie_word_embeddings:
        emb = params["embed"]["weight"]
        logits = x.float() @ emb.t().to(x.dtype).float()
    else:
        # the head's output is cast to x's dtype first, as in the JAX
        # package, so greedy ids see the same rounding
        logits = linear(x, head, comp).float()[..., :cfg.vocab_size]
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    return logits, cache


# ---------------------------------------------------------------------------
# projection fusion (load-time params transform)
# ---------------------------------------------------------------------------


def _fuse_group(parts) -> Optional[Params]:
    """Concat the linears `parts` along N, or None if they do not fuse."""
    ws = [p.get("w") for p in parts]
    if any(w is None for w in ws) or any(p.get("perm") is not None
                                         for p in parts):
        return None
    if all(isinstance(w, QTensor) for w in ws):
        try:
            w = concat_n(ws)
        except ValueError:
            return None
    elif not any(isinstance(w, QTensor) for w in ws):
        if len({w.shape[0] for w in ws}) != 1:
            return None
        w = torch.cat([w.to(ws[0].dtype) for w in ws], dim=1)
    else:
        return None
    fused = {"w": w}
    if any(p.get("b") is not None for p in parts):
        some_b = next(p["b"] for p in parts if p.get("b") is not None)
        fused["b"] = torch.cat([
            p["b"].to(some_b.dtype) if p.get("b") is not None
            else torch.zeros((ww.shape[1],), dtype=some_b.dtype,
                             device=some_b.device)
            for p, ww in zip(parts, ws)])
    return fused


def _kernel_pack(val: QTensor) -> QTensor:
    """Load-time K-repad to the pack period x group, for every family
    (llama's 11008 FFN-down K becomes 11264 at g = 128 for one 4-bit plane,
    12288 where a 1- or 2-bit plane sets the period; FP8 and INT8 rows need
    none).  Odd widths stay planar: kernel P reads them as stored, so the
    JAX package's `widen_bits` fallback is not taken."""
    g = val.spec.effective_group(val.shape[0])
    return repad_k(val, kernel_k_multiple(val.spec) * g)


def _repad_tree(node):
    if isinstance(node, dict):
        return {key: (_kernel_pack(val) if key == "w"
                      and isinstance(val, QTensor) else _repad_tree(val))
                for key, val in node.items()}
    if isinstance(node, list):
        return [_repad_tree(v) for v in node]
    return node


def fuse_params(params: Params, cfg: ArchConfig) -> Params:
    """Fuse per-layer Q/K/V and gate/up projections into single packed
    weights (one kernel launch instead of three / two, same math) and
    K-repad packed weights.  The LM head keeps its N: the JAX package's
    512-lane N-repad is a TPU choice the port drops."""
    out = dict(params)
    layers = []
    for lp in params.get("layers", []):
        lp = dict(lp)
        if all(key in lp for key in ("q", "k", "v")):
            f = _fuse_group([lp["q"], lp["k"], lp["v"]])
            if f is not None:
                lp["qkv"] = f
                del lp["q"], lp["k"], lp["v"]
        ffn_p = lp.get("ffn")
        if ffn_p is not None and "gate" in ffn_p and "up" in ffn_p:
            f = _fuse_group([ffn_p["gate"], ffn_p["up"]])
            if f is not None:
                ffn_p = {k: v for k, v in ffn_p.items()
                         if k not in ("gate", "up")}
                ffn_p["gateup"] = f
                lp["ffn"] = ffn_p
        layers.append(lp)
    out["layers"] = layers
    return _repad_tree(out)
