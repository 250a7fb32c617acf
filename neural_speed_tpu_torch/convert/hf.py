"""HF float checkpoint -> params, with optional RTN quantization (port of
`neural_speed_tpu/convert/hf.py`).

Linear weights are transposed to `[in, out]` and quantized to `QTensor`s
by the port's `ops.quantize.quantize` (packs equal the JAX converter's bit
for bit), or kept dense in `dtype` where the group does not divide K (as
Falcon-7B's K = 4544 at g = 128).  Every step is a torch op on the device
of the state dict's tensors (or on `device`), so the card converts a 7B
checkpoint itself, one linear at a time.  The mappers of chatglm2 and
qwen-1 wait with their archs (ROADMAP section 1, item 1).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..models.arch import ArchConfig
from ..ops.qtypes import QSpec
from ..ops.quantize import quantize, quantize_tree

StateDict = Dict[str, Any]


class Converter:
    """Builds the params tree, quantizing matmul weights on the way."""

    def __init__(self, cfg: ArchConfig, qspec: Optional[QSpec],
                 dtype=torch.bfloat16, quantize_lm_head: bool = True,
                 device=None):
        self.cfg = cfg
        self.qspec = qspec
        self.dtype = dtype
        self.quantize_lm_head = quantize_lm_head
        self.device = device

    def f32(self, t) -> torch.Tensor:
        """A state-dict entry (tensor or numpy array) as float32, on
        `device` when one was given."""
        t = t if isinstance(t, torch.Tensor) else torch.from_numpy(
            np.asarray(t))
        if self.device is not None:
            t = t.to(self.device)
        return t.float()

    # -- leaf builders ---------------------------------------------------
    def dense(self, w) -> torch.Tensor:
        return self.f32(w).to(self.dtype)

    def linear(self, w_out_in, b=None, quant: bool = True) -> Dict[str, Any]:
        """torch Linear weight [out, in] -> {"w": [in, out], "b"}."""
        w = self.f32(w_out_in).t().contiguous()
        k = w.shape[0]
        if quant and self.qspec is not None and k % self._group(k) == 0:
            wq = quantize(w, self.qspec)
        else:
            wq = w.to(self.dtype)
        out = {"w": wq}
        if b is not None:
            out["b"] = self.f32(b)
        return out

    def _group(self, k: int) -> int:
        g = self.qspec.group_size
        return k if g == -1 else g

    def norm_p(self, w, b=None) -> Dict[str, Any]:
        out = {"weight": self.f32(w)}
        if b is not None:
            out["bias"] = self.f32(b)
        return out


# ---------------------------------------------------------------------------
# per-arch state-dict mappers
# ---------------------------------------------------------------------------


def _split_fused_neox_qkv(w: torch.Tensor, n_heads: int, head_dim: int):
    """GPT-NeoX fused query_key_value: rows laid out per head as
    [q(h0) k(h0) v(h0) q(h1) ...]."""
    w3 = w.reshape(n_heads, 3, head_dim, -1)
    q = w3[:, 0].reshape(n_heads * head_dim, -1)
    k = w3[:, 1].reshape(n_heads * head_dim, -1)
    v = w3[:, 2].reshape(n_heads * head_dim, -1)
    return q, k, v


def _split_fused_neox_bias(b: torch.Tensor, n_heads: int, head_dim: int):
    b3 = b.reshape(n_heads, 3, head_dim)
    return (b3[:, 0].reshape(-1), b3[:, 1].reshape(-1), b3[:, 2].reshape(-1))


def _split_bloom_qkv(w: torch.Tensor, n_heads: int, head_dim: int):
    """Bloom fused qkv: [H, 3, D] row grouping."""
    return _split_fused_neox_qkv(w, n_heads, head_dim)


def _split_falcon_qkv(w: torch.Tensor, cfg: ArchConfig):
    """Falcon fused qkv rows: per kv-group [q(g)*n_rep, k(g), v(g)]."""
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_rep = h // hkv
    w3 = w.reshape(hkv, n_rep + 2, d, -1)
    q = w3[:, :n_rep].reshape(h * d, -1)
    k = w3[:, n_rep].reshape(hkv * d, -1)
    v = w3[:, n_rep + 1].reshape(hkv * d, -1)
    return q, k, v


def map_llama(sd: StateDict, cfg: ArchConfig, cv: Converter) -> Dict[str, Any]:
    """llama / mistral / qwen2 / gemma / phi3(fused) / stablelm-like."""
    p: Dict[str, Any] = {
        "embed": {"weight": cv.dense(sd["model.embed_tokens.weight"])},
        "layers": [],
    }
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        lp: Dict[str, Any] = {}
        lp["attn_norm"] = cv.norm_p(sd[pre + "input_layernorm.weight"],
                                    sd.get(pre + "input_layernorm.bias"))
        if pre + "self_attn.qkv_proj.weight" in sd:  # phi3 fused
            wqkv = cv.f32(sd[pre + "self_attn.qkv_proj.weight"])
            qd, kvd = cfg.q_dim, cfg.kv_dim
            lp["q"] = cv.linear(wqkv[:qd])
            lp["k"] = cv.linear(wqkv[qd : qd + kvd])
            lp["v"] = cv.linear(wqkv[qd + kvd :])
        elif pre + "self_attn.W_pack.weight" in sd:  # baichuan fused
            wqkv = cv.f32(sd[pre + "self_attn.W_pack.weight"])
            qd = cfg.q_dim
            lp["q"] = cv.linear(wqkv[:qd])
            lp["k"] = cv.linear(wqkv[qd : 2 * qd])
            lp["v"] = cv.linear(wqkv[2 * qd :])
        else:
            for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                                 ("v", "v_proj")):
                lp[ours] = cv.linear(
                    sd[pre + f"self_attn.{theirs}.weight"],
                    sd.get(pre + f"self_attn.{theirs}.bias"),
                )
        lp["o"] = cv.linear(sd[pre + "self_attn.o_proj.weight"],
                            sd.get(pre + "self_attn.o_proj.bias"))
        lp["ffn_norm"] = cv.norm_p(
            sd[pre + "post_attention_layernorm.weight"],
            sd.get(pre + "post_attention_layernorm.bias"),
        )
        if cfg.moe is not None:  # mixtral
            moe = {
                "router": cv.linear(sd[pre + "block_sparse_moe.gate.weight"],
                                    quant=False),
                "experts": [],
            }
            for e in range(cfg.moe.num_experts):
                ep = pre + f"block_sparse_moe.experts.{e}."
                moe["experts"].append(
                    {
                        "gate": cv.linear(sd[ep + "w1.weight"]),
                        "down": cv.linear(sd[ep + "w2.weight"]),
                        "up": cv.linear(sd[ep + "w3.weight"]),
                    }
                )
            lp["moe"] = moe
        elif pre + "mlp.gate_up_proj.weight" in sd:  # phi3 fused
            wgu = cv.f32(sd[pre + "mlp.gate_up_proj.weight"])
            inter = cfg.intermediate_size
            lp["ffn"] = {
                "gate": cv.linear(wgu[:inter]),
                "up": cv.linear(wgu[inter:]),
                "down": cv.linear(sd[pre + "mlp.down_proj.weight"]),
            }
        else:
            lp["ffn"] = {
                "gate": cv.linear(sd[pre + "mlp.gate_proj.weight"]),
                "up": cv.linear(sd[pre + "mlp.up_proj.weight"]),
                "down": cv.linear(sd[pre + "mlp.down_proj.weight"]),
            }
        p["layers"].append(lp)
    p["final_norm"] = cv.norm_p(sd["model.norm.weight"],
                                sd.get("model.norm.bias"))
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        p["lm_head"] = cv.linear(sd["lm_head.weight"],
                                 quant=cv.quantize_lm_head)
    return p


def map_gptj(sd: StateDict, cfg: ArchConfig, cv: Converter) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "embed": {"weight": cv.dense(sd["transformer.wte.weight"])},
        "layers": [],
    }
    for i in range(cfg.n_layers):
        pre = f"transformer.h.{i}."
        lp = {
            "attn_norm": cv.norm_p(sd[pre + "ln_1.weight"],
                                   sd[pre + "ln_1.bias"]),
            "q": cv.linear(sd[pre + "attn.q_proj.weight"]),
            "k": cv.linear(sd[pre + "attn.k_proj.weight"]),
            "v": cv.linear(sd[pre + "attn.v_proj.weight"]),
            "o": cv.linear(sd[pre + "attn.out_proj.weight"]),
            "ffn": {
                "up": cv.linear(sd[pre + "mlp.fc_in.weight"],
                                sd[pre + "mlp.fc_in.bias"]),
                "down": cv.linear(sd[pre + "mlp.fc_out.weight"],
                                  sd[pre + "mlp.fc_out.bias"]),
            },
        }
        p["layers"].append(lp)
    p["final_norm"] = cv.norm_p(sd["transformer.ln_f.weight"],
                                sd["transformer.ln_f.bias"])
    p["lm_head"] = cv.linear(sd["lm_head.weight"], sd.get("lm_head.bias"),
                             quant=cv.quantize_lm_head)
    return p


def map_gptneox(sd: StateDict, cfg: ArchConfig, cv: Converter) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "embed": {"weight": cv.dense(sd["gpt_neox.embed_in.weight"])},
        "layers": [],
    }
    h, d = cfg.n_heads, cfg.head_dim
    for i in range(cfg.n_layers):
        pre = f"gpt_neox.layers.{i}."
        q, k, v = _split_fused_neox_qkv(
            cv.f32(sd[pre + "attention.query_key_value.weight"]), h, d
        )
        qb, kb, vb = _split_fused_neox_bias(
            cv.f32(sd[pre + "attention.query_key_value.bias"]), h, d
        )
        lp = {
            "attn_norm": cv.norm_p(sd[pre + "input_layernorm.weight"],
                                   sd[pre + "input_layernorm.bias"]),
            "ffn_norm": cv.norm_p(sd[pre + "post_attention_layernorm.weight"],
                                  sd[pre + "post_attention_layernorm.bias"]),
            "q": cv.linear(q, qb),
            "k": cv.linear(k, kb),
            "v": cv.linear(v, vb),
            "o": cv.linear(sd[pre + "attention.dense.weight"],
                           sd[pre + "attention.dense.bias"]),
            "ffn": {
                "up": cv.linear(sd[pre + "mlp.dense_h_to_4h.weight"],
                                sd[pre + "mlp.dense_h_to_4h.bias"]),
                "down": cv.linear(sd[pre + "mlp.dense_4h_to_h.weight"],
                                  sd[pre + "mlp.dense_4h_to_h.bias"]),
            },
        }
        p["layers"].append(lp)
    p["final_norm"] = cv.norm_p(sd["gpt_neox.final_layer_norm.weight"],
                                sd["gpt_neox.final_layer_norm.bias"])
    p["lm_head"] = cv.linear(sd["embed_out.weight"],
                             quant=cv.quantize_lm_head)
    return p


def map_opt(sd: StateDict, cfg: ArchConfig, cv: Converter) -> Dict[str, Any]:
    dec = "model.decoder."
    p: Dict[str, Any] = {
        "embed": {"weight": cv.dense(sd[dec + "embed_tokens.weight"])},
        "pos_embed": {
            "weight": cv.dense(sd[dec + "embed_positions.weight"])
        },
        "layers": [],
    }
    for i in range(cfg.n_layers):
        pre = f"{dec}layers.{i}."
        lp = {
            "attn_norm": cv.norm_p(sd[pre + "self_attn_layer_norm.weight"],
                                   sd[pre + "self_attn_layer_norm.bias"]),
            "ffn_norm": cv.norm_p(sd[pre + "final_layer_norm.weight"],
                                  sd[pre + "final_layer_norm.bias"]),
            "q": cv.linear(sd[pre + "self_attn.q_proj.weight"],
                           sd[pre + "self_attn.q_proj.bias"]),
            "k": cv.linear(sd[pre + "self_attn.k_proj.weight"],
                           sd[pre + "self_attn.k_proj.bias"]),
            "v": cv.linear(sd[pre + "self_attn.v_proj.weight"],
                           sd[pre + "self_attn.v_proj.bias"]),
            "o": cv.linear(sd[pre + "self_attn.out_proj.weight"],
                           sd[pre + "self_attn.out_proj.bias"]),
            "ffn": {
                "up": cv.linear(sd[pre + "fc1.weight"], sd[pre + "fc1.bias"]),
                "down": cv.linear(sd[pre + "fc2.weight"],
                                  sd[pre + "fc2.bias"]),
            },
        }
        p["layers"].append(lp)
    p["final_norm"] = cv.norm_p(sd[dec + "final_layer_norm.weight"],
                                sd[dec + "final_layer_norm.bias"])
    return p


def map_bloom(sd: StateDict, cfg: ArchConfig, cv: Converter) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "embed": {
            "weight": cv.dense(sd["transformer.word_embeddings.weight"])
        },
        "embed_ln": cv.norm_p(
            sd["transformer.word_embeddings_layernorm.weight"],
            sd["transformer.word_embeddings_layernorm.bias"],
        ),
        "layers": [],
    }
    h, d = cfg.n_heads, cfg.head_dim
    for i in range(cfg.n_layers):
        pre = f"transformer.h.{i}."
        q, k, v = _split_bloom_qkv(
            cv.f32(sd[pre + "self_attention.query_key_value.weight"]), h, d
        )
        qb, kb, vb = _split_fused_neox_bias(
            cv.f32(sd[pre + "self_attention.query_key_value.bias"]), h, d
        )
        lp = {
            "attn_norm": cv.norm_p(sd[pre + "input_layernorm.weight"],
                                   sd[pre + "input_layernorm.bias"]),
            "ffn_norm": cv.norm_p(sd[pre + "post_attention_layernorm.weight"],
                                  sd[pre + "post_attention_layernorm.bias"]),
            "q": cv.linear(q, qb),
            "k": cv.linear(k, kb),
            "v": cv.linear(v, vb),
            "o": cv.linear(sd[pre + "self_attention.dense.weight"],
                           sd[pre + "self_attention.dense.bias"]),
            "ffn": {
                "up": cv.linear(sd[pre + "mlp.dense_h_to_4h.weight"],
                                sd[pre + "mlp.dense_h_to_4h.bias"]),
                "down": cv.linear(sd[pre + "mlp.dense_4h_to_h.weight"],
                                  sd[pre + "mlp.dense_4h_to_h.bias"]),
            },
        }
        p["layers"].append(lp)
    p["final_norm"] = cv.norm_p(sd["transformer.ln_f.weight"],
                                sd["transformer.ln_f.bias"])
    return p


def map_falcon(sd: StateDict, cfg: ArchConfig, cv: Converter) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "embed": {
            "weight": cv.dense(sd["transformer.word_embeddings.weight"])
        },
        "layers": [],
    }
    for i in range(cfg.n_layers):
        pre = f"transformer.h.{i}."
        q, k, v = _split_falcon_qkv(
            cv.f32(sd[pre + "self_attention.query_key_value.weight"]), cfg
        )
        if pre + "ln_attn.weight" in sd:  # 40B two-norm wiring
            attn_norm = cv.norm_p(sd[pre + "ln_attn.weight"],
                                  sd[pre + "ln_attn.bias"])
            ffn_norm = cv.norm_p(sd[pre + "ln_mlp.weight"],
                                 sd[pre + "ln_mlp.bias"])
        else:
            attn_norm = cv.norm_p(sd[pre + "input_layernorm.weight"],
                                  sd[pre + "input_layernorm.bias"])
            ffn_norm = None
        lp = {
            "attn_norm": attn_norm,
            "q": cv.linear(q),
            "k": cv.linear(k),
            "v": cv.linear(v),
            "o": cv.linear(sd[pre + "self_attention.dense.weight"]),
            "ffn": {
                "up": cv.linear(sd[pre + "mlp.dense_h_to_4h.weight"]),
                "down": cv.linear(sd[pre + "mlp.dense_4h_to_h.weight"]),
            },
        }
        if ffn_norm is not None:
            lp["ffn_norm"] = ffn_norm
        p["layers"].append(lp)
    p["final_norm"] = cv.norm_p(sd["transformer.ln_f.weight"],
                                sd["transformer.ln_f.bias"])
    p["lm_head"] = cv.linear(sd["lm_head.weight"], quant=cv.quantize_lm_head)
    return p


def map_mpt(sd: StateDict, cfg: ArchConfig, cv: Converter) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "embed": {"weight": cv.dense(sd["transformer.wte.weight"])},
        "layers": [],
    }
    qd, kvd = cfg.q_dim, cfg.kv_dim
    for i in range(cfg.n_layers):
        pre = f"transformer.blocks.{i}."
        wqkv = cv.f32(sd[pre + "attn.Wqkv.weight"])
        lp = {
            "attn_norm": cv.norm_p(sd[pre + "norm_1.weight"]),
            "ffn_norm": cv.norm_p(sd[pre + "norm_2.weight"]),
            "q": cv.linear(wqkv[:qd]),
            "k": cv.linear(wqkv[qd : qd + kvd]),
            "v": cv.linear(wqkv[qd + kvd :]),
            "o": cv.linear(sd[pre + "attn.out_proj.weight"]),
            "ffn": {
                "up": cv.linear(sd[pre + "ffn.up_proj.weight"]),
                "down": cv.linear(sd[pre + "ffn.down_proj.weight"]),
            },
        }
        p["layers"].append(lp)
    p["final_norm"] = cv.norm_p(sd["transformer.norm_f.weight"])
    return p


def map_starcoder(sd: StateDict, cfg: ArchConfig, cv: Converter) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "embed": {"weight": cv.dense(sd["transformer.wte.weight"])},
        "pos_embed": {"weight": cv.dense(sd["transformer.wpe.weight"])},
        "layers": [],
    }
    qd, kvd = cfg.q_dim, cfg.kv_dim
    for i in range(cfg.n_layers):
        pre = f"transformer.h.{i}."
        wqkv = cv.f32(sd[pre + "attn.c_attn.weight"])
        bqkv = cv.f32(sd[pre + "attn.c_attn.bias"])
        lp = {
            "attn_norm": cv.norm_p(sd[pre + "ln_1.weight"],
                                   sd[pre + "ln_1.bias"]),
            "ffn_norm": cv.norm_p(sd[pre + "ln_2.weight"],
                                  sd[pre + "ln_2.bias"]),
            "q": cv.linear(wqkv[:qd], bqkv[:qd]),
            "k": cv.linear(wqkv[qd : qd + kvd], bqkv[qd : qd + kvd]),
            "v": cv.linear(wqkv[qd + kvd :], bqkv[qd + kvd :]),
            "o": cv.linear(sd[pre + "attn.c_proj.weight"],
                           sd[pre + "attn.c_proj.bias"]),
            "ffn": {
                "up": cv.linear(sd[pre + "mlp.c_fc.weight"],
                                sd[pre + "mlp.c_fc.bias"]),
                "down": cv.linear(sd[pre + "mlp.c_proj.weight"],
                                  sd[pre + "mlp.c_proj.bias"]),
            },
        }
        p["layers"].append(lp)
    p["final_norm"] = cv.norm_p(sd["transformer.ln_f.weight"],
                                sd["transformer.ln_f.bias"])
    return p


def map_phi(sd: StateDict, cfg: ArchConfig, cv: Converter) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "embed": {"weight": cv.dense(sd["model.embed_tokens.weight"])},
        "layers": [],
    }
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        lp = {
            "attn_norm": cv.norm_p(sd[pre + "input_layernorm.weight"],
                                   sd[pre + "input_layernorm.bias"]),
            "q": cv.linear(sd[pre + "self_attn.q_proj.weight"],
                           sd[pre + "self_attn.q_proj.bias"]),
            "k": cv.linear(sd[pre + "self_attn.k_proj.weight"],
                           sd[pre + "self_attn.k_proj.bias"]),
            "v": cv.linear(sd[pre + "self_attn.v_proj.weight"],
                           sd[pre + "self_attn.v_proj.bias"]),
            "o": cv.linear(sd[pre + "self_attn.dense.weight"],
                           sd[pre + "self_attn.dense.bias"]),
            "ffn": {
                "up": cv.linear(sd[pre + "mlp.fc1.weight"],
                                sd[pre + "mlp.fc1.bias"]),
                "down": cv.linear(sd[pre + "mlp.fc2.weight"],
                                  sd[pre + "mlp.fc2.bias"]),
            },
        }
        p["layers"].append(lp)
    p["final_norm"] = cv.norm_p(sd["model.final_layernorm.weight"],
                                sd["model.final_layernorm.bias"])
    p["lm_head"] = cv.linear(sd["lm_head.weight"], sd.get("lm_head.bias"),
                             quant=cv.quantize_lm_head)
    return p


def map_grok(sd: StateDict, cfg: ArchConfig, cv: Converter) -> Dict[str, Any]:
    """Grok-1 in the hpcai-tech key scheme: transformer.decoder_layer.N.*
    with the sandwich norms rms_norm_1 (after attention) / rms_norm_2 (the
    FFN norm) / rms_norm_3 (after the MoE), per-expert moe.E.linear (gate)
    / linear_1 (down) / linear_v (up), and the embedding
    transformer.in_out_embed, which the head shares."""
    p: Dict[str, Any] = {
        "embed": {"weight": cv.dense(sd["transformer.in_out_embed.weight"])},
        "layers": [],
    }
    for i in range(cfg.n_layers):
        pre = f"transformer.decoder_layer.{i}."
        att = pre + "multi_head_attention."
        moe: Dict[str, Any] = {
            "router": cv.linear(sd[pre + "router.weight"], quant=False),
            "experts": [],
            "post_norm": cv.norm_p(sd[pre + "rms_norm_3.weight"]),
        }
        for e in range(cfg.moe.num_experts):
            ep = pre + f"moe.{e}."
            moe["experts"].append({
                "gate": cv.linear(sd[ep + "linear.weight"]),
                "down": cv.linear(sd[ep + "linear_1.weight"]),
                "up": cv.linear(sd[ep + "linear_v.weight"]),
            })
        p["layers"].append({
            "attn_norm": cv.norm_p(sd[pre + "rms_norm.weight"]),
            "q": cv.linear(sd[att + "query.weight"]),
            "k": cv.linear(sd[att + "key.weight"]),
            "v": cv.linear(sd[att + "value.weight"]),
            "o": cv.linear(sd[att + "linear.weight"]),
            "post_attn_norm": cv.norm_p(sd[pre + "rms_norm_1.weight"]),
            "ffn_norm": cv.norm_p(sd[pre + "rms_norm_2.weight"]),
            "moe": moe,
        })
    p["final_norm"] = cv.norm_p(sd["transformer.rms_norm.weight"])
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        p["lm_head"] = cv.linear(sd["lm_head.weight"],
                                 quant=cv.quantize_lm_head)
    return p


MAPPERS: Dict[str, Callable] = {
    "llama": map_llama,
    "mistral": map_llama,
    "mixtral": map_llama,
    "qwen2": map_llama,
    "phi3": map_llama,
    "gemma": map_llama,
    "stablelm": map_llama,
    "baichuan": map_llama,
    "gptj": map_gptj,
    "gptneox": map_gptneox,
    "opt": map_opt,
    "bloom": map_bloom,
    "falcon": map_falcon,
    "mpt": map_mpt,
    "starcoder": map_starcoder,
    "phi": map_phi,
    "grok": map_grok,
    "grok-1": map_grok,
}


def params_from_state_dict(
    sd: StateDict,
    cfg: ArchConfig,
    qspec: Optional[QSpec] = None,
    dtype=torch.bfloat16,
    quantize_lm_head: bool = True,
    policy=None,
    device=None,
) -> Dict[str, Any]:
    """A float HF state dict -> params, converted where its tensors lie (or
    on `device`).  `policy(path) -> Optional[QSpec]` quantizes layer by
    layer instead: the mapping then runs in float32 and the tree is
    quantized per path afterwards (`quantize_tree`)."""
    if cfg.name not in MAPPERS:
        raise ValueError(f"no state-dict mapper for arch {cfg.name!r}")
    if policy is not None:
        cv = Converter(cfg, None, torch.float32, quantize_lm_head, device)
        return quantize_tree(MAPPERS[cfg.name](sd, cfg, cv), policy)
    cv = Converter(cfg, qspec, dtype, quantize_lm_head, device)
    return MAPPERS[cfg.name](sd, cfg, cv)
