"""Decoder forward (port of `neural_speed_tpu/models/transformer.py`: the
llama path with its mixture-of-experts FFN, and the knobs of the HF archs
the port converts: LayerNorm and gemma norms, embedding LN and scale,
non-gated GELU / ReLU MLPs, biases, clip_qkv, ALiBi, no rope, parallel
residual with one shared norm or two, learned positions, grok's logit
softcap and sandwich norms).

Params are a plain dict; linear leaves are a `QTensor` (int-packed, fed to
`qmatmul`) or a dense `[K, N]` tensor.  Positions and per-slot kv lengths
are explicit, as in the JAX package, so continuous batching can mix slots
at unrelated offsets.  The KV cache (contiguous `KVCache` or paged
`PagedKVCache`) is written in place.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops import kv_cache as kvc
from ..ops import flash
from ..ops import moe as moe_ops
from ..ops import paged_kv as pkv
from ..ops.attention import alibi_slopes, attention_cache
from ..ops.matmul import kernel_k_multiple, qmatmul, qmatmul_int8
from ..ops.norms import layer_norm, rms_norm
from ..ops.quantize import QTensor, concat_n, repad_k
from ..ops.rope import apply_rope, rope_cos_sin, rope_inv_freq
from .arch import ArchConfig

Params = Dict[str, Any]


_ACTS = {
    "silu": torch.nn.functional.silu,
    # jax.nn.gelu approximates with tanh by default
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "gelu_tanh": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "gelu_exact": torch.nn.functional.gelu,
    "relu": torch.nn.functional.relu,
}

# The knobs still refused, each with the ROADMAP item that ports it.
_WAITING = {
    "logn_attn": "queue 1 item 1: qwen",
    "rope_style chatglm": "queue 1 item 1: chatglm",
    "deepnorm_alpha": "queue 1 item 1: chatglm",
}


def check_supported(cfg: ArchConfig) -> None:
    """Raise for configurations outside the ported knobs, naming the
    ROADMAP item of each."""
    refused = {
        "logn_attn": cfg.logn_attn,
        "rope_style chatglm": cfg.rope_style == "chatglm",
        "deepnorm_alpha": cfg.deepnorm_alpha is not None,
    }
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(
                f"{k} (ROADMAP {_WAITING[k]})" for k in bad))
    if cfg.norm not in ("rms", "ln") or cfg.act not in _ACTS or (
            cfg.rope_style not in ("neox", "gptj", "none")):
        raise ValueError(f"unknown norm {cfg.norm!r}, act {cfg.act!r} or "
                         f"rope_style {cfg.rope_style!r}")


COMP_MODES = (None, "int8", "int8t")
INT8_MIN_ROWS = 32


def linear(x: torch.Tensor, p: Params,
           comp: Optional[str] = None) -> torch.Tensor:
    """p = {"w": QTensor | [K, N] tensor, "b": optional [N], "perm":
    optional [K]}; output in x's dtype (dense weights: float32
    accumulation, then the cast).  `perm` (GPTQ act-order) gathers x along
    K to the weight's group-contiguous row order, before the matmul and its
    K-pad.  `comp` "int8" / "int8t" (one activation scale per token) sends
    steps of at least 32 rows through `qmatmul_int8`; decode stays on the
    weight-only path, where activation quantization would add error and
    save no bytes."""
    perm = p.get("perm")
    if perm is not None:
        x = x.index_select(-1, perm)
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
    """RMSNorm, gemma's (1 + w) RMSNorm, or LayerNorm with an optional
    bias."""
    w = p["weight"]
    if cfg.norm == "rms":
        if cfg.gemma_norm:
            return rms_norm(x, w.float() + 1.0, cfg.norm_eps)
        return rms_norm(x, w, cfg.norm_eps)
    return layer_norm(x, w, p.get("bias"), cfg.norm_eps)


def ffn(x: torch.Tensor, p: Params, cfg: ArchConfig,
        comp: Optional[str] = None) -> torch.Tensor:
    """Gated MLP (fused gate+up when `fuse_params` made one), or the classic
    up / act / down MLP when `cfg.gated_ffn` is off; biases come with the
    linears."""
    a = _ACTS[cfg.act]
    if not cfg.gated_ffn:
        return linear(a(linear(x, p["up"], comp)), p["down"], comp)
    if "gateup" in p:
        gate, up = torch.chunk(linear(x, p["gateup"], comp), 2, dim=-1)
    else:
        gate, up = linear(x, p["gate"], comp), linear(x, p["up"], comp)
    return linear(a(gate) * up, p["down"], comp)


def _expert_view(stacked: dict, e: int) -> Params:
    """ffn()-shaped param dict for one expert of a stacked MoE block."""
    return {key: {"w": st.expert(e)} for key, st in stacked.items()}


def _moe_grouped(x: torch.Tensor, stacked: dict, topi: torch.Tensor,
                 probs: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Grouped expert dispatch for multi-token steps: token rows sorted by
    expert into block-aligned segments, the FFN chain as grouped GEMMs, then
    a gather-combine.  Rounding points as the JAX package's: float32 grouped
    outputs and activation, `mid` cast to x's dtype, float32 combine, the
    result cast to x's dtype."""
    b, t, h = x.shape
    n = b * t
    kk = topi.shape[-1]
    eid = topi.reshape(n * kk)
    max_k = max(st.local_view().shape[0] for st in stacked.values())
    bm = moe_ops.choose_bm(max_k, x.dtype, x.device)
    r = moe_ops.route_tokens(eid, cfg.moe.num_experts, kk, bm)

    xz = torch.cat([x.reshape(n, h), x.new_zeros((1, h))], dim=0)
    xs = xz.index_select(0, r.src)                       # [M_pad, H]

    def gq(a, st):
        return moe_ops.grouped_qmatmul(a, st, r.block_expert, bm,
                                       r.block_rows)

    a = _ACTS[cfg.act]
    if "gateup" in stacked:
        gate, up = torch.chunk(gq(xs, stacked["gateup"]), 2, dim=-1)
        mid = a(gate) * up
    else:
        mid = a(gq(xs, stacked["gate"])) * gq(xs, stacked["up"])
    y = gq(mid.to(x.dtype), stacked["down"])             # [M_pad, H] f32
    y_asg = y.index_select(0, r.dest_by_a).reshape(n, kk, h)
    p = probs.reshape(n, kk).float()
    out = y_asg[:, 0] * p[:, 0:1]
    for j in range(1, kk):
        out = out + y_asg[:, j] * p[:, j:j + 1]
    return out.reshape(b, t, h).to(x.dtype)


def _moe_single(x: torch.Tensor, stacked: dict, topi: torch.Tensor,
                probs: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """B*T == 1: the JAX package's `lax.switch` over the selected experts,
    as one per-row grouped launch per projection (row j = x, expert
    topi[j]); outputs rounded to x's dtype where `linear`'s are, then summed
    in float32 in the order j = 0, 1, ...  The expert ids stay on the
    device."""
    kk = topi.shape[-1]
    h = x.shape[-1]
    rows = x.reshape(1, h).expand(kk, h)
    row_e = topi.reshape(kk).to(torch.int32)

    def gq(a, st):
        return moe_ops.grouped_qmatmul_rows(a, st, row_e).to(x.dtype)

    if "gateup" in stacked:
        gate, up = torch.chunk(gq(rows, stacked["gateup"]), 2, dim=-1)
    else:
        gate, up = gq(rows, stacked["gate"]), gq(rows, stacked["up"])
    contrib = gq(_ACTS[cfg.act](gate) * up, stacked["down"]).float()
    p = probs.reshape(kk).float()
    out = torch.zeros((h,), dtype=torch.float32, device=x.device)
    for j in range(kk):
        out = out + contrib[j] * p[j]
    return out.reshape(x.shape).to(x.dtype)


def _top_k(logits: torch.Tensor, k: int):
    """`lax.top_k`: the k largest along the last axis, ties to the lower
    index (a stable descending sort; `torch.topk` leaves tie order open)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(x: torch.Tensor, p: Params, cfg: ArchConfig,
            ep_axis_name: Optional[str] = None,
            comp: Optional[str] = None) -> torch.Tensor:
    """Top-k expert mixing (mixtral; grok's router rule too).  Paths:

    * B*T == 1 over stacked experts: `_moe_single`;
    * multi-token over stacked experts (`fuse_params`): `_moe_grouped`;
    * experts that do not stack: every expert over every token (kernels A,
      F, P through `ffn`), weighted by the router; at B*T == 1 the selected
      outputs are picked on the device and summed in the order of top_k.

    Expert parallelism (`ep_axis_name`) is not ported."""
    if ep_axis_name is not None:
        raise NotImplementedError("expert parallelism is not ported yet")
    m = cfg.moe
    b, t, _ = x.shape
    router_logits = linear(x, p["router"]).float()             # [B, T, E]
    topv, topi = _top_k(router_logits, m.top_k)
    if m.renorm:
        # mixtral: softmax over the selected experts' logits
        probs = torch.softmax(topv, dim=-1)
    else:
        # grok: the global softmax's probabilities of the selected experts
        probs = torch.gather(torch.softmax(router_logits, dim=-1), -1, topi)
    stacked = p.get("experts_stacked")

    if stacked is not None:
        if b * t == 1:
            return _moe_single(x, stacked, topi, probs, cfg)
        return _moe_grouped(x, stacked, topi, probs, cfg)

    contribs = [ffn(x, ep, cfg, comp).float() for ep in p["experts"]]
    if b * t == 1:
        sel = torch.stack(contribs).reshape(m.num_experts, -1).index_select(
            0, topi.reshape(-1))                                # [top_k, H]
        pr = probs.reshape(-1)
        out = torch.zeros_like(sel[0])
        for j in range(m.top_k):
            out = out + sel[j] * pr[j]
        return out.reshape(x.shape).to(x.dtype)
    onehot = (topi[..., None] == torch.arange(
        m.num_experts, device=x.device)).float()                # [B,T,k,E]
    weights = torch.einsum("btk,btke->bte", probs, onehot)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e, contrib in enumerate(contribs):
        out = out + contrib * weights[..., e:e + 1]
    return out.to(x.dtype)


KV_APPEND_MODES = ("plain", "defer", "fused")


def kv_append_mode() -> str:
    """The decode KV-append path from the env, resolved as the JAX package
    does: `NST_KV_APPEND` in {plain, defer, fused} is taken as given;
    `NST_DEFER_APPEND=0` or `NST_FUSED_APPEND=0` steps down to "plain";
    otherwise "fused".  The engines call it once, at construction, and pin
    the result into their config."""
    mode = os.environ.get("NST_KV_APPEND")
    if mode in KV_APPEND_MODES:
        return mode
    if os.environ.get("NST_DEFER_APPEND", "1") == "0":
        return "plain"
    if os.environ.get("NST_FUSED_APPEND", "1") == "0":
        return "plain"
    return "fused"


def _resolved_kv_append(cfg: ArchConfig) -> str:
    mode = kv_append_mode() if cfg.kv_append == "env" else cfg.kv_append
    if mode not in KV_APPEND_MODES:
        raise ValueError(f"kv_append must be 'env' or one of "
                         f"{KV_APPEND_MODES}, got {mode!r}")
    return mode


def _defer_append(cfg: ArchConfig, cache, t: int) -> str:
    """The append mode ("defer" or "fused") when a single-token decode takes
    the current k/v as attention operands, over the quantized cache only, as
    in the JAX package; "" when it appends first.  On the page pool only
    "fused" defers; "defer" falls to plain there.  The JAX package's
    `flash_enabled` condition is dropped: the decode kernel's plain version
    always exists in the port."""
    mode = _resolved_kv_append(cfg)
    if mode == "plain" or not cache.quantized:
        return ""
    if isinstance(cache, pkv.PagedKVCache) and mode != "fused":
        return ""
    return mode if flash.extra_kv_eligible(t, cfg.n_heads,
                                           cfg.n_kv_heads) else ""


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
                  cos: Optional[torch.Tensor], sin: Optional[torch.Tensor],
                  comp: Optional[str] = None,
                  slopes: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, kvc.KVCache]:
    b, t, _ = x.shape
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    attn_in = norm(x, lp["attn_norm"], cfg)
    if "qkv" in lp:
        q, k, v = torch.split(linear(attn_in, lp["qkv"], comp),
                              [h * d, hkv * d, hkv * d], dim=-1)
    else:
        q, k, v = (linear(attn_in, lp[n], comp) for n in ("q", "k", "v"))
    q, k, v = (q.reshape(b, t, h, d), k.reshape(b, t, hkv, d),
               v.reshape(b, t, hkv, d))
    if cfg.clip_qkv:
        q, k, v = (a.clamp(-cfg.clip_qkv, cfg.clip_qkv) for a in (q, k, v))
    if cos is not None:
        q = apply_rope(q, cos, sin, cfg.rope_style, cfg.rot_dim)
        k = apply_rope(k, cos, sin, cfg.rope_style, cfg.rot_dim)

    # active slots are those whose kv_lens advance past their first written
    # position (spectator slots keep kv_lens == old length)
    active = kv_lens > positions[:, 0]
    attn_kwargs = dict(scale=cfg.attn_scale if cfg.attn_scale is not None
                       else 1.0 / math.sqrt(d), causal=True, alibi=slopes,
                       logit_softcap=cfg.logit_softcap, out_dtype=x.dtype)
    mode = _defer_append(cfg, cache, t)
    fused = None
    if mode == "fused":
        fused = attention_cache(q, cache, layer_idx, positions, kv_lens,
                                extra_kv=(k, v), fused_append=True,
                                **attn_kwargs)
    if fused is not None:
        attn_out, cache = fused
    elif mode == "defer":
        # attention over the cache with the new k/v as operands, then the
        # append (kernel B's extra-kv column without its in-kernel append)
        attn_out = attention_cache(q, cache, layer_idx, positions, kv_lens,
                                   extra_kv=(k, v), **attn_kwargs)
        cache = _cache_append(cache, layer_idx, k, v, positions, active)
    else:
        cache = _cache_append(cache, layer_idx, k, v, positions, active)
        attn_out = attention_cache(q, cache, layer_idx, positions, kv_lens,
                                   **attn_kwargs)
    attn_out = linear(attn_out.reshape(b, t, h * d), lp["o"], comp)
    if cfg.post_attn_norm:
        # grok's sandwich norm on the attention output
        attn_out = norm(attn_out, lp["post_attn_norm"], cfg)

    if cfg.parallel_residual:
        # gptj / gptneox / phi / falcon: x + attn(n(x)) + ffn(n'(x)), with
        # one shared norm or a second one
        ffn_in = (attn_in if cfg.shared_parallel_norm
                  else norm(x, lp["ffn_norm"], cfg))
        return x + attn_out + _ffn_block(ffn_in, lp, cfg, comp), cache
    h1 = x + attn_out
    ffn_in = norm(h1, lp["ffn_norm"], cfg)
    return h1 + _ffn_block(ffn_in, lp, cfg, comp), cache


def _ffn_block(ffn_in: torch.Tensor, lp: Params, cfg: ArchConfig,
               comp: Optional[str]) -> torch.Tensor:
    """The layer's dense FFN, or its MoE FFN with the optional pre / post
    norms, then the optional post-FFN norm."""
    if cfg.moe is None:
        out = ffn(ffn_in, lp["ffn"], cfg, comp)
    else:
        mp = lp["moe"]
        if cfg.moe.pre_norm:
            ffn_in = norm(ffn_in, mp["pre_norm"], cfg)
        out = moe_ffn(ffn_in, mp, cfg, comp=comp)
        if cfg.moe.post_norm:
            out = norm(out, mp["post_norm"], cfg)
    if cfg.post_ffn_norm:
        out = norm(out, lp["post_ffn_norm"], cfg)
    return out


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
    if cfg.embed_scale != 1.0:
        x = x * x.new_full((), cfg.embed_scale)
    if cfg.embedding_ln:
        x = layer_norm(x, params["embed_ln"]["weight"],
                       params["embed_ln"].get("bias"), cfg.norm_eps)
    if cfg.learned_pos:
        # learned absolute positions with an offset (opt's 2)
        x = x + params["pos_embed"]["weight"][positions + cfg.pos_offset]
    cos = sin = None
    if cfg.rope_style in ("neox", "gptj"):
        rot = cfg.rot_dim or cfg.head_dim
        inv_freq, mscale = rope_inv_freq(rot, cfg.rope_base, cfg.rope_scaling,
                                         seq_len=cache.max_len,
                                         device=x.device)
        cos, sin = rope_cos_sin(positions, inv_freq, mscale)
    # ALiBi slopes, once per forward
    slopes = alibi_slopes(cfg.n_heads, x.device) if cfg.use_alibi else None
    for i, lp in enumerate(params["layers"]):
        x, cache = decoder_layer(x, lp, cfg, i, cache, positions, kv_lens,
                                 cos, sin, comp, slopes)
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


def _fuse_gateup(ffn_p: Optional[Params]) -> Optional[Params]:
    if ffn_p is None or "gate" not in ffn_p or "up" not in ffn_p:
        return ffn_p
    f = _fuse_group([ffn_p["gate"], ffn_p["up"]])
    if f is None:
        return ffn_p
    ffn_p = {k: v for k, v in ffn_p.items() if k not in ("gate", "up")}
    ffn_p["gateup"] = f
    return ffn_p


def _stack_expert_ffns(experts) -> Optional[Dict[str, Any]]:
    """Stack each projection of the expert FFNs, or None when any expert
    is not stackable (mixed structures, biases, act-order perms, dense
    weights)."""
    if not experts:
        return None
    keys = set(experts[0].keys())
    if keys not in ({"gateup", "down"}, {"gate", "up", "down"},
                    {"up", "down"}):
        return None
    stacked = {}
    for key in keys:
        parts = [ep.get(key) for ep in experts]
        if any(pp is None or set(pp) - {"w"}
               or not isinstance(pp.get("w"), QTensor) for pp in parts):
            return None
        st = moe_ops.stack_experts([pp["w"] for pp in parts])
        if st is None:
            return None
        stacked[key] = st
    return stacked


def fuse_params(params: Params, cfg: ArchConfig) -> Params:
    """Fuse per-layer Q/K/V and gate/up projections into single packed
    weights (one kernel launch instead of three / two, same math), K-repad
    packed weights, then stack a layer's list of MoE experts into
    `experts_stacked` where they stack (after the repad, as the JAX
    package).  The LM head keeps its N: the JAX package's 512-lane N-repad
    is a TPU choice the port drops."""
    out = dict(params)
    layers = []
    for lp in params.get("layers", []):
        lp = dict(lp)
        if all(key in lp for key in ("q", "k", "v")):
            f = _fuse_group([lp["q"], lp["k"], lp["v"]])
            if f is not None:
                lp["qkv"] = f
                del lp["q"], lp["k"], lp["v"]
        if "ffn" in lp:
            lp["ffn"] = _fuse_gateup(lp["ffn"])
        moe_p = lp.get("moe")
        if isinstance(moe_p, dict) and "experts" in moe_p:
            lp["moe"] = dict(moe_p, experts=[_fuse_gateup(e)
                                             for e in moe_p["experts"]])
        layers.append(lp)
    out["layers"] = layers
    out = _repad_tree(out)
    for lp in out["layers"]:
        moe_p = lp.get("moe")
        if isinstance(moe_p, dict) and "experts" in moe_p:
            st = _stack_expert_ffns(moe_p["experts"])
            if st is not None:
                moe_p["experts_stacked"] = st
                del moe_p["experts"]
    return out
