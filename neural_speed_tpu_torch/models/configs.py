"""HF config -> ArchConfig (a copy of the builders of
`neural_speed_tpu/models/configs.py` and of its `arch_from_hf_config`).

Every builder of the JAX package is here but qwen-1's and chatglm's: their
knobs (logn attention, chatglm rope and deepnorm) are not ported, so those
model types raise `NotImplementedError` naming their ROADMAP item.
"""

from __future__ import annotations

import math
from typing import Any, Dict

from ..ops.rope import RopeScaling
from .arch import ArchConfig, MoEConfig


def _rope_scaling_from_hf(cfg: Dict[str, Any]) -> RopeScaling | None:
    rs = cfg.get("rope_scaling")
    if not rs:
        return None
    kind = (rs.get("rope_type") or rs.get("type") or "none").lower()
    if kind in ("linear",):
        return RopeScaling("linear", factor=rs.get("factor", 1.0))
    if kind in ("dynamic", "ntk"):
        return RopeScaling("ntk", factor=rs.get("factor", 1.0))
    if kind == "yarn":
        return RopeScaling(
            "yarn",
            factor=rs.get("factor", 1.0),
            original_max_position=rs.get(
                "original_max_position_embeddings", 2048
            ),
            beta_fast=rs.get("beta_fast", 32.0),
            beta_slow=rs.get("beta_slow", 1.0),
            attn_factor=rs.get("attention_factor", 1.0) or 1.0,
        )
    if kind in ("longrope", "su"):
        return RopeScaling(
            "longrope",
            factor=rs.get("factor", 1.0),
            original_max_position=rs.get(
                "original_max_position_embeddings",
                cfg.get("original_max_position_embeddings", 4096),
            ),
            long_factors=tuple(rs.get("long_factor", [])) or None,
            short_factors=tuple(rs.get("short_factor", [])) or None,
        )
    return None


def llama_arch(hf: Dict[str, Any], name: str = "llama") -> ArchConfig:
    """llama / llama2 / llama3 / mistral / tinyllama."""
    n_heads = hf["num_attention_heads"]
    return ArchConfig(
        name=name,
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=hf.get("num_key_value_heads", n_heads),
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        head_dim=hf.get("head_dim"),
        norm="rms",
        norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_style="neox",
        rope_base=hf.get("rope_theta", 10000.0),
        rope_scaling=_rope_scaling_from_hf(hf),
        act=hf.get("hidden_act", "silu"),
        gated_ffn=True,
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )


def mixtral_arch(hf: Dict[str, Any]) -> ArchConfig:
    base = llama_arch(hf, "mixtral")
    return ArchConfig(
        **{
            **base.__dict__,
            "moe": MoEConfig(
                num_experts=hf.get("num_local_experts", 8),
                top_k=hf.get("num_experts_per_tok", 2),
            ),
        }
    )


# The published config.json of mistralai/Mixtral-8x7B-v0.1 (the fields the
# builders read).
MIXTRAL_8X7B_HF = {
    "vocab_size": 32000, "hidden_size": 4096, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "intermediate_size": 14336, "max_position_embeddings": 32768,
    "rms_norm_eps": 1e-5, "rope_theta": 1e6, "hidden_act": "silu",
    "num_local_experts": 8, "num_experts_per_tok": 2,
    "tie_word_embeddings": False,
}


def qwen2_arch(hf: Dict[str, Any]) -> ArchConfig:
    base = llama_arch(hf, "qwen2")
    return ArchConfig(**{**base.__dict__, "qkv_bias": True})


def gemma_arch(hf: Dict[str, Any]) -> ArchConfig:
    """gemma.cpp:46-104: head_dim != hidden/n_heads, GELU-gate FFN,
    (1+w) rmsnorm, embedding scaled by sqrt(hidden)."""
    base = llama_arch(hf, "gemma")
    return ArchConfig(
        **{
            **base.__dict__,
            "head_dim": hf["head_dim"],
            "gemma_norm": True,
            "act": "gelu_tanh",
            "embed_scale": math.sqrt(hf["hidden_size"]),
            "tie_word_embeddings": True,
            "norm_eps": hf.get("rms_norm_eps", 1e-6),
        }
    )


def phi_arch(hf: Dict[str, Any]) -> ArchConfig:
    """phi-1/2 (phi.cpp): partial rotary, parallel residual w/ shared LN,
    biases everywhere, untied head."""
    n_heads = hf["num_attention_heads"]
    hd = hf["hidden_size"] // n_heads
    return ArchConfig(
        name="phi",
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=hf.get("num_key_value_heads") or n_heads,
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf.get("max_position_embeddings", 2048),
        norm="ln",
        norm_eps=hf.get("layer_norm_eps", 1e-5),
        rope_style="neox",
        rope_base=hf.get("rope_theta", 10000.0),
        rot_dim=int(hf.get("partial_rotary_factor", 0.5) * hd),
        qkv_bias=True,
        o_bias=True,
        mlp_bias=True,
        act="gelu_tanh",
        gated_ffn=False,
        parallel_residual=True,
        shared_parallel_norm=True,
    )


def phi3_arch(hf: Dict[str, Any]) -> ArchConfig:
    """phi3.cpp:182-188: llama-like + LongRoPE."""
    base = llama_arch(hf, "phi3")
    return ArchConfig(
        **{
            **base.__dict__,
            "rope_scaling": _rope_scaling_from_hf(hf),
            "tie_word_embeddings": hf.get("tie_word_embeddings", False),
        }
    )


def stablelm_arch(hf: Dict[str, Any]) -> ArchConfig:
    """stablelm.cpp:177-183: partial rotary, LN, gated silu ffn."""
    n_heads = hf["num_attention_heads"]
    hd = hf["hidden_size"] // n_heads
    return ArchConfig(
        name="stablelm",
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=hf.get("num_key_value_heads", n_heads),
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        norm="ln",
        norm_eps=hf.get("layer_norm_eps", 1e-5),
        rope_style="neox",
        rope_base=hf.get("rope_theta", 10000.0),
        rot_dim=int(hf.get("partial_rotary_factor", 0.25) * hd),
        qkv_bias=hf.get("use_qkv_bias", False),
        act="silu",
        gated_ffn=True,
    )


def gptj_arch(hf: Dict[str, Any]) -> ArchConfig:
    """gptj.cpp:184-232: parallel attn+FFN sharing one LN, interleaved rope
    on first n_rot dims, untied head w/ bias."""
    n_heads = hf["n_head"]
    return ArchConfig(
        name="gptj",
        vocab_size=hf["vocab_size"],
        hidden_size=hf["n_embd"],
        n_layers=hf["n_layer"],
        n_heads=n_heads,
        n_kv_heads=n_heads,
        intermediate_size=hf.get("n_inner") or 4 * hf["n_embd"],
        max_position_embeddings=hf.get("n_positions", 2048),
        norm="ln",
        norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        rope_style="gptj",
        rot_dim=hf.get("rotary_dim"),
        act="gelu_tanh",
        gated_ffn=False,
        mlp_bias=True,
        o_bias=False,
        parallel_residual=True,
        shared_parallel_norm=True,
    )


def gptneox_arch(hf: Dict[str, Any]) -> ArchConfig:
    """gptneox.cpp:183-209: neox rope mode 2 on partial dims, optional
    parallel residual with *two* norms."""
    n_heads = hf["num_attention_heads"]
    hd = hf["hidden_size"] // n_heads
    return ArchConfig(
        name="gptneox",
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=n_heads,
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf.get("max_position_embeddings", 2048),
        norm="ln",
        norm_eps=hf.get("layer_norm_eps", 1e-5),
        rope_style="neox",
        rot_dim=int(hf.get("rotary_pct", 0.25) * hd),
        rope_base=hf.get("rotary_emb_base", 10000.0),
        qkv_bias=True,
        o_bias=True,
        mlp_bias=True,
        act="gelu",
        gated_ffn=False,
        parallel_residual=hf.get("use_parallel_residual", True),
        shared_parallel_norm=False,
    )


def mpt_arch(hf: Dict[str, Any]) -> ArchConfig:
    """mpt.cpp:182-242: ALiBi, clip_qkv, no rope, no biases."""
    n_heads = hf["n_heads"]
    attn_cfg = hf.get("attn_config", {})
    return ArchConfig(
        name="mpt",
        vocab_size=hf["vocab_size"],
        hidden_size=hf["d_model"],
        n_layers=hf["n_layers"],
        n_heads=n_heads,
        n_kv_heads=attn_cfg.get("kv_n_heads", n_heads),
        intermediate_size=hf.get("expansion_ratio", 4) * hf["d_model"],
        max_position_embeddings=hf.get("max_seq_len", 2048),
        norm="ln",
        norm_eps=1e-5,
        rope_style="none",
        use_alibi=True,
        clip_qkv=attn_cfg.get("clip_qkv"),
        act="gelu",
        gated_ffn=False,
        tie_word_embeddings=True,
    )


def bloom_arch(hf: Dict[str, Any]) -> ArchConfig:
    """bloom.cpp:191-256: ALiBi + learned embedding LN."""
    n_heads = hf.get("n_head") or hf["num_attention_heads"]
    hidden = hf.get("hidden_size") or hf["n_embd"]
    return ArchConfig(
        name="bloom",
        vocab_size=hf["vocab_size"],
        hidden_size=hidden,
        n_layers=hf.get("n_layer") or hf["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=n_heads,
        intermediate_size=4 * hidden,
        max_position_embeddings=2048,
        norm="ln",
        norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        rope_style="none",
        use_alibi=True,
        embedding_ln=True,
        qkv_bias=True,
        o_bias=True,
        mlp_bias=True,
        act="gelu",
        gated_ffn=False,
        tie_word_embeddings=True,
    )


def falcon_arch(hf: Dict[str, Any]) -> ArchConfig:
    """falcon.cpp:75-153: MQA/GQA, parallel residual (one norm for 7B, two
    for 40B), no biases on qkv, gelu mlp."""
    n_heads = hf["num_attention_heads"]
    new_decoder = hf.get("new_decoder_architecture", False)
    if new_decoder:  # falcon-40b/180b: true GQA group count
        n_kv = hf.get("num_kv_heads") or hf.get("n_head_kv", 8)
    elif hf.get("multi_query", True):
        n_kv = 1
    else:
        n_kv = n_heads
    return ArchConfig(
        name="falcon",
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=n_kv if (new_decoder or hf.get("multi_query", True)) else n_heads,
        intermediate_size=4 * hf["hidden_size"],
        max_position_embeddings=2048,
        norm="ln",
        norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        rope_style="none" if hf.get("alibi", False) else "neox",
        rope_base=hf.get("rope_theta", 10000.0),
        use_alibi=hf.get("alibi", False),
        act="gelu",
        gated_ffn=False,
        parallel_residual=hf.get("parallel_attn", True),
        shared_parallel_norm=not new_decoder,
        tie_word_embeddings=True,
    )


def opt_arch(hf: Dict[str, Any]) -> ArchConfig:
    """opt.cpp:99-110: learned positions with offset 2, ReLU MLP, LN."""
    return ArchConfig(
        name="opt",
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf["num_attention_heads"],
        intermediate_size=hf["ffn_dim"],
        max_position_embeddings=hf.get("max_position_embeddings", 2048),
        norm="ln",
        norm_eps=1e-5,
        rope_style="none",
        learned_pos=True,
        pos_offset=2,
        qkv_bias=True,
        o_bias=True,
        mlp_bias=True,
        act=hf.get("activation_function", "relu"),
        gated_ffn=False,
        tie_word_embeddings=True,
    )


def starcoder_arch(hf: Dict[str, Any]) -> ArchConfig:
    """starcoder.cpp: MQA + learned absolute positions, gelu mlp."""
    return ArchConfig(
        name="starcoder",
        vocab_size=hf["vocab_size"],
        hidden_size=hf["n_embd"],
        n_layers=hf["n_layer"],
        n_heads=hf["n_head"],
        n_kv_heads=1 if hf.get("multi_query", True) else hf["n_head"],
        intermediate_size=hf.get("n_inner") or 4 * hf["n_embd"],
        max_position_embeddings=hf.get("n_positions", 8192),
        norm="ln",
        norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        rope_style="none",
        learned_pos=True,
        qkv_bias=True,
        o_bias=True,
        mlp_bias=True,
        act="gelu_tanh",
        gated_ffn=False,
        tie_word_embeddings=True,
    )


def baichuan_arch(hf: Dict[str, Any]) -> ArchConfig:
    """baichuan.cpp:210: fused W_pack qkv; 13B uses ALiBi, 7B rope."""
    base = llama_arch(hf, "baichuan")
    use_alibi = hf["hidden_size"] >= 5120  # 13B
    return ArchConfig(
        **{
            **base.__dict__,
            "use_alibi": use_alibi,
            "rope_style": "none" if use_alibi else "neox",
        }
    )


# The published config.json of mosaicml/mpt-7b, bigscience/bloom-7b1 and
# tiiuae/falcon-7b (the fields the builders read).
MPT_7B_HF = {
    "model_type": "mpt", "d_model": 4096, "n_heads": 32, "n_layers": 32,
    "expansion_ratio": 4, "max_seq_len": 2048, "vocab_size": 50432,
    "no_bias": True,
    "attn_config": {"alibi": True, "clip_qkv": None,
                    "attn_type": "multihead_attention"},
}
BLOOM_7B1_HF = {
    "model_type": "bloom", "hidden_size": 4096, "n_head": 32, "n_layer": 30,
    "vocab_size": 250880, "layer_norm_epsilon": 1e-5,
}
FALCON_7B_HF = {
    "model_type": "falcon", "hidden_size": 4544, "num_attention_heads": 71,
    "num_hidden_layers": 32, "vocab_size": 65024, "multi_query": True,
    "parallel_attn": True, "alibi": False, "bias": False,
    "new_decoder_architecture": False, "layer_norm_epsilon": 1e-5,
}

# The published config.json of google/gemma-7b, EleutherAI/gpt-j-6b,
# microsoft/phi-2 and EleutherAI/gpt-neox-20b (the fields the builders
# read): head dims 256, 256, 80 and 96.
GEMMA_7B_HF = {
    "model_type": "gemma", "hidden_size": 3072, "num_hidden_layers": 28,
    "num_attention_heads": 16, "num_key_value_heads": 16, "head_dim": 256,
    "intermediate_size": 24576, "vocab_size": 256000,
    "max_position_embeddings": 8192, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "hidden_activation": "gelu_pytorch_tanh",
    "tie_word_embeddings": True,
}
GPTJ_6B_HF = {
    "model_type": "gptj", "n_embd": 4096, "n_layer": 28, "n_head": 16,
    "rotary_dim": 64, "vocab_size": 50400, "n_positions": 2048,
    "n_inner": None, "layer_norm_epsilon": 1e-5,
    "activation_function": "gelu_new", "tie_word_embeddings": False,
}
PHI_2_HF = {
    "model_type": "phi", "hidden_size": 2560, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 32,
    "partial_rotary_factor": 0.4, "intermediate_size": 10240,
    "vocab_size": 51200, "max_position_embeddings": 2048,
    "layer_norm_eps": 1e-5, "rope_theta": 10000.0,
    "hidden_act": "gelu_new", "tie_word_embeddings": False,
}
GPTNEOX_20B_HF = {
    "model_type": "gpt_neox", "hidden_size": 6144, "num_hidden_layers": 44,
    "num_attention_heads": 64, "rotary_pct": 0.25,
    "rotary_emb_base": 10000, "intermediate_size": 24576,
    "vocab_size": 50432, "max_position_embeddings": 2048,
    "layer_norm_eps": 1e-5, "use_parallel_residual": True,
    "hidden_act": "gelu_fast", "tie_word_embeddings": False,
}


def grok_arch(hf: Dict[str, Any]) -> ArchConfig:
    """Grok-1: a tanh logit softcap of 30 on the attention scores, GELU
    experts, sandwich norms (the attention output and the MoE output are
    RMS-normed before their residual adds; the only pre-MoE norm is the
    regular FFN norm), the router's global softmax probabilities of the
    selected experts without renormalization, the embedding and the logits
    scaled by the config's multipliers, the head tied to the embedding."""
    n_heads = hf["num_attention_heads"]
    return ArchConfig(
        name="grok",
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=hf.get("num_key_value_heads", n_heads),
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf.get("max_position_embeddings", 8192),
        norm="rms",
        norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_style="neox",
        logit_softcap=30.0,
        act="gelu_tanh",
        gated_ffn=True,
        post_attn_norm=True,
        moe=MoEConfig(
            num_experts=hf.get("num_local_experts", 8),
            top_k=hf.get("num_experts_per_tok", 2),
            post_norm=True,
            renorm=False,
        ),
        logit_scale=hf.get("output_multiplier_scale", 1.0),
        embed_scale=hf.get("embedding_multiplier_scale", 1.0),
        tie_word_embeddings=True,
    )


# The published config.json of hpcai-tech/grok-1 (the fields the builder
# reads, and the expert counts as that file names them).
GROK_1_HF = {
    "model_type": "grok-1", "vocab_size": 131072, "hidden_size": 6144,
    "intermediate_size": 32768, "num_hidden_layers": 64,
    "num_attention_heads": 48, "num_key_value_heads": 8,
    "max_position_embeddings": 8192, "rms_norm_eps": 1e-5,
    "num_experts": 8, "num_experts_per_tok": 2,
    "embedding_multiplier_scale": 78.38367176906169,
    "output_multiplier_scale": 0.5773502691896257,
}


def _waits(item: str):
    """A builder for a model type whose knobs are not ported yet."""
    def build(hf: Dict[str, Any]) -> ArchConfig:
        raise NotImplementedError(
            f"model_type {hf.get('model_type')!r} is not ported yet (ROADMAP "
            f"section 1, {item})")
    return build


_QWEN = _waits("item 1: qwen-1's logn attention")
_CHATGLM = _waits("item 1: chatglm's rope and deepnorm")

ARCH_BUILDERS = {
    "llama": llama_arch,
    "mistral": lambda hf: llama_arch(hf, "mistral"),
    "mixtral": mixtral_arch,
    "qwen": _QWEN,
    "qwen2": qwen2_arch,
    "gemma": gemma_arch,
    "phi": phi_arch,
    "phi3": phi3_arch,
    "stablelm": stablelm_arch,
    "gptj": gptj_arch,
    "gpt_neox": gptneox_arch,
    "gptneox": gptneox_arch,
    "mpt": mpt_arch,
    "bloom": bloom_arch,
    "falcon": falcon_arch,
    "RefinedWeb": falcon_arch,
    "RefinedWebModel": falcon_arch,
    "opt": opt_arch,
    "gpt_bigcode": starcoder_arch,
    "starcoder": starcoder_arch,
    "baichuan": baichuan_arch,
    "chatglm": _CHATGLM,
    "chatglm2": _CHATGLM,
    "chatglm3": _CHATGLM,
    "grok-1": grok_arch,
    "grok": grok_arch,
}


def arch_from_hf_config(hf: Dict[str, Any]) -> ArchConfig:
    """`model_type` -> ArchConfig; the types whose knobs are not ported
    raise `NotImplementedError`, unknown ones `ValueError`."""
    mt = hf.get("model_type", "")
    if mt == "chatglm" and hf.get("multi_query_attention") is not None:
        mt = "chatglm2"
    if mt in ARCH_BUILDERS:
        return ARCH_BUILDERS[mt](hf)
    raise ValueError(f"unsupported model_type {mt!r}")
