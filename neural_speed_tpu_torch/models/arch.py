"""Architecture configuration (a copy of `neural_speed_tpu/models/arch.py`).

One decoder skeleton (models/transformer.py) is parameterized by this
config.  The port runs the llama path of it so far; the other knobs are
kept so a config carries across unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..ops.rope import RopeScaling


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts (mixtral/grok)."""

    num_experts: int
    top_k: int
    pre_norm: bool = False
    post_norm: bool = False
    renorm: bool = True


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    vocab_size: int
    hidden_size: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    intermediate_size: int
    max_position_embeddings: int = 4096
    head_dim: Optional[int] = None

    # --- norms ---
    norm: str = "rms"                   # "rms" | "ln"
    norm_eps: float = 1e-5
    gemma_norm: bool = False
    embedding_ln: bool = False
    final_norm: bool = True
    post_attn_norm: bool = False
    post_ffn_norm: bool = False

    # --- attention ---
    qkv_bias: bool = False
    o_bias: bool = False
    clip_qkv: Optional[float] = None
    use_alibi: bool = False
    logit_softcap: float = 0.0
    logn_attn: bool = False
    attn_scale: Optional[float] = None

    # --- rope ---
    rope_style: str = "neox"            # "neox" | "gptj" | "none" | "chatglm"
    rope_base: float = 10000.0
    rot_dim: Optional[int] = None
    rope_scaling: Optional[RopeScaling] = None

    # --- positions ---
    learned_pos: bool = False
    pos_offset: int = 0

    # --- ffn ---
    act: str = "silu"
    gated_ffn: bool = True
    mlp_bias: bool = False
    parallel_residual: bool = False
    shared_parallel_norm: bool = False

    # --- scaling conventions ---
    embed_scale: float = 1.0
    logit_scale: float = 1.0
    deepnorm_alpha: Optional[float] = None

    # --- moe ---
    moe: Optional[MoEConfig] = None

    # --- head ---
    tie_word_embeddings: bool = False

    # --- runtime: decode KV-append path ---
    #   "plain" — append-then-attend
    #   "defer" — attention takes the new k/v as operands, then appends
    #   "fused" — the decode attention kernel writes the new row itself
    # "env" (the JAX package's default) resolves to "fused" in the port.
    kv_append: str = "env"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(
                self, "head_dim", self.hidden_size // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim
