"""HF config -> ArchConfig for the ported archs (a copy of the llama and
mixtral builders of `neural_speed_tpu/models/configs.py`, and of its
`arch_from_hf_config` for them).

Only the llama path and its MoE variant run in the port so far; the other
archs' builders come with their knobs (ROADMAP section 1, item 1).
"""

from __future__ import annotations

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


ARCH_BUILDERS = {
    "llama": llama_arch,
    "mistral": lambda hf: llama_arch(hf, "mistral"),
    "mixtral": mixtral_arch,
}

# model types the JAX package builds whose knobs the port has not yet
_NOT_PORTED = (
    "qwen", "qwen2", "gemma", "phi", "phi3", "stablelm", "gptj", "gpt_neox",
    "gptneox", "mpt", "bloom", "falcon", "RefinedWeb", "RefinedWebModel",
    "opt", "gpt_bigcode", "starcoder", "baichuan", "chatglm", "chatglm2",
    "chatglm3", "grok-1", "grok")


def arch_from_hf_config(hf: Dict[str, Any]) -> ArchConfig:
    """`model_type` -> ArchConfig for the ported archs; the JAX package's
    other archs raise `NotImplementedError`, unknown ones `ValueError`."""
    mt = hf.get("model_type", "")
    if mt in ARCH_BUILDERS:
        return ARCH_BUILDERS[mt](hf)
    if mt in _NOT_PORTED:
        raise NotImplementedError(
            f"model_type {mt!r} is not ported yet (ROADMAP section 1, item 1: "
            f"the HF archs)")
    raise ValueError(f"unsupported model_type {mt!r}")
