"""Synthetic models (port of `neural_speed_tpu/utils/synthetic.py`): packed
quantized params, and float HF-layout state dicts for the converter.

Random packed bits are valid planes of every family (INT planes, NF4/FP4
codes, INT8 bytes; FP8 bytes come from a cast random normal), so a
Llama-2-7B- or Mixtral-8x7B-shaped model is drawn directly on the target
device with a seeded `torch.Generator`: nothing is quantized and nothing is
drawn on the host.  A MoE layer's experts are drawn straight into their
`[E, ...]` stacks, layer by layer.  The draws differ from the
JAX package's `jax.random` streams; tests carry the JAX parameters across
with `models.params.params_from_numpy` instead.

`synth_hf_state_dict` draws a float checkpoint in an HF model's own
tensor names and layouts (fused QKV rows as the model stores them), so
`convert/hf.py` converts and quantizes a full-size model on the card.
`write_whisper_checkpoint` draws whisper-large-v2
(`whisper_large_v2_config`) in `WhisperForConditionalGeneration`'s names
and writes it (`write_safetensors`) as a directory `AudioModel.init`
reads.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict

import torch

from .._build import resolve_device
from ..models.arch import ArchConfig
from ..models.configs import (BLOOM_7B1_HF, FALCON_7B_HF, GEMMA_7B_HF,
                              GPTJ_6B_HF, GPTNEOX_20B_HF, GROK_1_HF,
                              MIXTRAL_8X7B_HF, MPT_7B_HF, PHI_2_HF,
                              arch_from_hf_config, bloom_arch, falcon_arch,
                              grok_arch, mixtral_arch, mpt_arch)
from ..ops.moe import StackedExperts
from ..ops.qtypes import QSpec, QType, plane_widths
from ..ops.quantize import QTensor

_SCALE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _draw_pack(gen: torch.Generator, lead: tuple, k: int, n: int,
               spec: QSpec, scale: float):
    """Planes, scales and zeros of a random pack `[*lead, K, N]`."""
    dev = gen.device
    g = spec.effective_group(k)
    if spec.qtype == QType.INT and spec.bits == 8:
        data = (torch.randint(0, 256, (*lead, k, n), generator=gen,
                              device=dev, dtype=torch.uint8),)
    elif spec.is_fp8:
        dt = (torch.float8_e4m3fn if spec.qtype == QType.FP8_E4M3
              else torch.float8_e5m2)
        data = (torch.randn((*lead, k, n), generator=gen, device=dev).to(
            dt).view(torch.uint8),)
    else:
        bits = 4 if spec.is_lut else spec.bits
        data = tuple(
            torch.randint(-2 ** 31, 2 ** 31, (*lead, k * w // 32, n),
                          generator=gen, device=dev, dtype=torch.int32)
            for w in plane_widths(bits))
    scales = ((torch.rand((*lead, k // g, n), generator=gen, device=dev)
               + 0.5) * scale).to(_SCALE_DTYPES[spec.scale_dtype])
    zeros = None
    if spec.qtype == QType.INT and not spec.symmetric:
        zeros = torch.randint(0, 2 ** spec.bits, (*lead, k // g, n),
                              generator=gen, device=dev, dtype=torch.uint8)
    return data, scales, zeros


def synth_qtensor(gen: torch.Generator, k: int, n: int, spec: QSpec,
                  scale: float = 0.02) -> QTensor:
    """Random pack `[K, N]` of any family on `gen`'s device: uniform plane
    words (INT widths below 8, NF4/FP4), uniform bytes (INT8), a random
    normal cast to the fp8 type (FP8, so no NaN/inf code is drawn); group
    scales uniform in [0.5, 1.5) * scale; uniform uint8 zero points for
    asymmetric specs."""
    data, scales, zeros = _draw_pack(gen, (), k, n, spec, scale)
    return QTensor(data, scales, zeros, None, spec, (k, n))


def synth_stacked(gen: torch.Generator, n_experts: int, k: int, n: int,
                  spec: QSpec, scale: float = 0.02) -> StackedExperts:
    """`n_experts` random packs `[K, N]` drawn as one `[E, ...]` stack (the
    draws of `synth_qtensor` with a leading axis), so no per-expert copy is
    made.  FP8 and other packs `stack_experts` refuses stay per-expert
    lists in real models; here they stack all the same."""
    data, scales, zeros = _draw_pack(gen, (n_experts,), k, n, spec, scale)
    return StackedExperts(data, scales, zeros, spec, (k, n), n_experts)


def synth_params(cfg: ArchConfig, spec: QSpec, seed: int = 0,
                 dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Random llama-path params on `device` (the card unless the CPU is
    asked for).  A MoE config gets the JAX package's tree: a float32 router
    `[H, E]` and `experts_stacked` with `gate` / `up` / `down`.  The
    sandwich norms (`post_attn_norm`, `post_ffn_norm`) come with their
    config flags, as in the JAX package; a config whose head is tied to the
    embedding gets no `lm_head` (the forward never reads it)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    e = cfg.hidden_size

    def lin(k, n):
        return {"w": synth_qtensor(gen, k, n, spec)}

    def ones():
        return {"weight": torch.ones((e,), dtype=torch.float32, device=dev)}

    p: Dict[str, Any] = {
        "embed": {"weight": (torch.randn((cfg.vocab_size, e), generator=gen,
                                         device=dev) * 0.02).to(dtype)},
        "layers": [],
        "final_norm": ones(),
    }
    if not cfg.tie_word_embeddings:
        p["lm_head"] = lin(e, cfg.vocab_size)
    inter = cfg.intermediate_size
    for _ in range(cfg.n_layers):
        lp = {"attn_norm": ones(), "ffn_norm": ones(),
              "q": lin(e, cfg.q_dim), "k": lin(e, cfg.kv_dim),
              "v": lin(e, cfg.kv_dim), "o": lin(cfg.q_dim, e)}
        if cfg.post_attn_norm:
            lp["post_attn_norm"] = ones()
        if cfg.post_ffn_norm:
            lp["post_ffn_norm"] = ones()
        if cfg.moe is None:
            lp["ffn"] = {"gate": lin(e, inter), "up": lin(e, inter),
                         "down": lin(inter, e)}
        else:
            n_exp = cfg.moe.num_experts
            lp["moe"] = {
                "router": {"w": torch.randn((e, n_exp), generator=gen,
                                            device=dev) * 0.02},
                "experts_stacked": {
                    "gate": synth_stacked(gen, n_exp, e, inter, spec),
                    "up": synth_stacked(gen, n_exp, e, inter, spec),
                    "down": synth_stacked(gen, n_exp, inter, e, spec)},
            }
            if cfg.moe.pre_norm:
                lp["moe"]["pre_norm"] = ones()
            if cfg.moe.post_norm:
                lp["moe"]["post_norm"] = ones()
        p["layers"].append(lp)
    return p


def llama2_7b_arch(vocab: int = 32000) -> ArchConfig:
    """Llama-2-7B shape (the JAX package's headline benchmark config)."""
    return ArchConfig(
        name="llama", vocab_size=vocab, hidden_size=4096, n_layers=32,
        n_heads=32, n_kv_heads=32, intermediate_size=11008,
        max_position_embeddings=4096,
    )


def mixtral_8x7b_arch() -> ArchConfig:
    """Mixtral-8x7B shape (its published config.json): 32 layers, hidden
    4096, 32 heads over 8 KV heads, 8 experts of width 14336, top-2."""
    return mixtral_arch(MIXTRAL_8X7B_HF)


def mpt_7b_arch() -> ArchConfig:
    """mosaicml/mpt-7b: d_model 4096, 32 heads, 32 layers, expansion 4,
    vocab 50432, ALiBi, no biases, the head tied to the embedding."""
    return mpt_arch(MPT_7B_HF)


def bloom_7b1_arch() -> ArchConfig:
    """bigscience/bloom-7b1: hidden 4096, 32 heads, 30 layers, vocab
    250880, ALiBi, embedding LayerNorm, biases, the head tied."""
    return bloom_arch(BLOOM_7B1_HF)


def falcon_7b_arch() -> ArchConfig:
    """tiiuae/falcon-7b: hidden 4544, 71 query heads over one KV head
    (head dim 64), 32 layers, vocab 65024, parallel attention and MLP
    sharing one LayerNorm, rope."""
    return falcon_arch(FALCON_7B_HF)


def gemma_7b_arch() -> ArchConfig:
    """google/gemma-7b: hidden 3072, 16 heads over 16 KV heads of head dim
    256 (q_dim 4096), 28 layers, GELU-gated FFN of 24576, vocab 256000,
    (1 + w) RMSNorm, the head tied to the embedding."""
    return arch_from_hf_config(GEMMA_7B_HF)


def gptj_6b_arch() -> ArchConfig:
    """EleutherAI/gpt-j-6b: hidden 4096, 16 heads of head dim 256, 28
    layers, rotary on the first 64 dims of each head, parallel attention
    and MLP sharing one LayerNorm, vocab 50400, an untied head with a
    bias."""
    return arch_from_hf_config(GPTJ_6B_HF)


def phi_2_arch() -> ArchConfig:
    """microsoft/phi-2: hidden 2560, 32 heads of head dim 80, 32 layers,
    rotary on 32 dims (partial_rotary_factor 0.4), parallel attention and
    MLP sharing one LayerNorm, biases everywhere, vocab 51200."""
    return arch_from_hf_config(PHI_2_HF)


def gptneox_20b_arch() -> ArchConfig:
    """EleutherAI/gpt-neox-20b: hidden 6144, 64 heads of head dim 96, 44
    layers, rotary on 24 dims (rotary_pct 0.25), parallel residual with two
    LayerNorms, FFN 24576, vocab 50432, an untied head."""
    return arch_from_hf_config(GPTNEOX_20B_HF)


def grok_1_arch(n_layers: int = 16) -> ArchConfig:
    """hpcai-tech/grok-1 (its published config.json): hidden 6144, 48
    query heads over 8 KV heads of head dim 128, 8 experts of width 32768,
    top-2, vocab 131072 tied to the head, logit softcap 30, sandwich norms;
    `n_layers` of its 64 (all 64 take about 151 GiB in int4, more than one
    card holds)."""
    return grok_arch(dict(GROK_1_HF, num_hidden_layers=n_layers))


def _linear(out: Dict[str, tuple], name: str, n: int, k: int,
            bias: bool) -> None:
    out[name + ".weight"] = (n, k)
    if bias:
        out[name + ".bias"] = (n,)


def _norm(out: Dict[str, tuple], name: str, e: int, bias: bool = True
          ) -> None:
    out[name + ".weight"] = (e,)
    if bias:
        out[name + ".bias"] = (e,)


def hf_shapes(model_type: str, cfg: ArchConfig) -> Dict[str, tuple]:
    """Tensor names and shapes of an HF checkpoint of `model_type` (mpt,
    bloom, falcon with one shared norm, llama, gemma, gptj, phi, gpt_neox;
    grok-1 in the hpcai-tech key scheme) for `cfg`, as `transformers` (or that
    checkpoint) names them, without the tied head's alias; linear weights
    are [out, in] as torch stores them."""
    e, v = cfg.hidden_size, cfg.vocab_size
    qd, kvd = cfg.q_dim, cfg.kv_dim
    qkv = qd + 2 * kvd
    ff = cfg.intermediate_size
    out: Dict[str, tuple] = {}
    if model_type == "mpt":
        out["transformer.wte.weight"] = (v, e)
        for i in range(cfg.n_layers):
            p = f"transformer.blocks.{i}."
            out.update({p + "norm_1.weight": (e,), p + "norm_2.weight": (e,),
                        p + "attn.Wqkv.weight": (qkv, e),
                        p + "attn.out_proj.weight": (e, cfg.q_dim),
                        p + "ffn.up_proj.weight": (ff, e),
                        p + "ffn.down_proj.weight": (e, ff)})
        out["transformer.norm_f.weight"] = (e,)
    elif model_type == "bloom":
        out["transformer.word_embeddings.weight"] = (v, e)
        for n in ("weight", "bias"):
            out["transformer.word_embeddings_layernorm." + n] = (e,)
        for i in range(cfg.n_layers):
            p = f"transformer.h.{i}."
            for n in ("weight", "bias"):
                out.update({p + "input_layernorm." + n: (e,),
                            p + "post_attention_layernorm." + n: (e,)})
            out.update({
                p + "self_attention.query_key_value.weight": (qkv, e),
                p + "self_attention.query_key_value.bias": (qkv,),
                p + "self_attention.dense.weight": (e, cfg.q_dim),
                p + "self_attention.dense.bias": (e,),
                p + "mlp.dense_h_to_4h.weight": (ff, e),
                p + "mlp.dense_h_to_4h.bias": (ff,),
                p + "mlp.dense_4h_to_h.weight": (e, ff),
                p + "mlp.dense_4h_to_h.bias": (e,)})
        for n in ("weight", "bias"):
            out["transformer.ln_f." + n] = (e,)
    elif model_type == "falcon":
        out["transformer.word_embeddings.weight"] = (v, e)
        for i in range(cfg.n_layers):
            p = f"transformer.h.{i}."
            out.update({
                p + "input_layernorm.weight": (e,),
                p + "input_layernorm.bias": (e,),
                p + "self_attention.query_key_value.weight": (qkv, e),
                p + "self_attention.dense.weight": (e, cfg.q_dim),
                p + "mlp.dense_h_to_4h.weight": (ff, e),
                p + "mlp.dense_4h_to_h.weight": (e, ff)})
        out["transformer.ln_f.weight"] = (e,)
        out["transformer.ln_f.bias"] = (e,)
        out["lm_head.weight"] = (v, e)
    elif model_type in ("gemma", "llama"):
        out["model.embed_tokens.weight"] = (v, e)
        for i in range(cfg.n_layers):
            p = f"model.layers.{i}."
            for name, n, k in (("self_attn.q_proj", qd, e),
                               ("self_attn.k_proj", kvd, e),
                               ("self_attn.v_proj", kvd, e),
                               ("self_attn.o_proj", e, qd),
                               ("mlp.gate_proj", ff, e),
                               ("mlp.up_proj", ff, e),
                               ("mlp.down_proj", e, ff)):
                _linear(out, p + name, n, k, False)
            _norm(out, p + "input_layernorm", e, False)
            _norm(out, p + "post_attention_layernorm", e, False)
        _norm(out, "model.norm", e, False)
        if not cfg.tie_word_embeddings:
            _linear(out, "lm_head", v, e, False)
    elif model_type == "gptj":
        out["transformer.wte.weight"] = (v, e)
        for i in range(cfg.n_layers):
            p = f"transformer.h.{i}."
            _norm(out, p + "ln_1", e)
            for name, n, k in (("attn.q_proj", qd, e), ("attn.k_proj", kvd, e),
                               ("attn.v_proj", kvd, e),
                               ("attn.out_proj", e, qd)):
                _linear(out, p + name, n, k, False)
            _linear(out, p + "mlp.fc_in", ff, e, True)
            _linear(out, p + "mlp.fc_out", e, ff, True)
        _norm(out, "transformer.ln_f", e)
        _linear(out, "lm_head", v, e, True)
    elif model_type == "phi":
        out["model.embed_tokens.weight"] = (v, e)
        for i in range(cfg.n_layers):
            p = f"model.layers.{i}."
            for name, n, k in (("self_attn.q_proj", qd, e),
                               ("self_attn.k_proj", kvd, e),
                               ("self_attn.v_proj", kvd, e),
                               ("self_attn.dense", e, qd), ("mlp.fc1", ff, e),
                               ("mlp.fc2", e, ff)):
                _linear(out, p + name, n, k, True)
            _norm(out, p + "input_layernorm", e)
        _norm(out, "model.final_layernorm", e)
        _linear(out, "lm_head", v, e, True)
    elif model_type == "gpt_neox":
        out["gpt_neox.embed_in.weight"] = (v, e)
        for i in range(cfg.n_layers):
            p = f"gpt_neox.layers.{i}."
            _norm(out, p + "input_layernorm", e)
            _norm(out, p + "post_attention_layernorm", e)
            for name, n, k in (("attention.query_key_value", qkv, e),
                               ("attention.dense", e, qd),
                               ("mlp.dense_h_to_4h", ff, e),
                               ("mlp.dense_4h_to_h", e, ff)):
                _linear(out, p + name, n, k, True)
        _norm(out, "gpt_neox.final_layer_norm", e)
        out["embed_out.weight"] = (v, e)
    elif model_type in ("grok", "grok-1"):
        out["transformer.in_out_embed.weight"] = (v, e)
        for i in range(cfg.n_layers):
            p = f"transformer.decoder_layer.{i}."
            for n in ("rms_norm", "rms_norm_1", "rms_norm_2", "rms_norm_3"):
                _norm(out, p + n, e, False)
            att = p + "multi_head_attention."
            for name, n, k in (("query", qd, e), ("key", kvd, e),
                               ("value", kvd, e), ("linear", e, qd)):
                _linear(out, att + name, n, k, False)
            out[p + "router.weight"] = (cfg.moe.num_experts, e)
            for x in range(cfg.moe.num_experts):
                for name, n, k in (("linear", ff, e), ("linear_1", e, ff),
                                   ("linear_v", ff, e)):
                    _linear(out, p + f"moe.{x}.{name}", n, k, False)
        _norm(out, "transformer.rms_norm", e, False)
    else:
        raise ValueError(f"no HF layout for model_type {model_type!r}")
    return out


def synth_hf_state_dict(model_type: str, cfg: ArchConfig, seed: int = 0,
                        dtype=torch.bfloat16, device=None
                        ) -> Dict[str, torch.Tensor]:
    """A random float HF checkpoint of `model_type` for `cfg`, drawn on
    `device` (the card unless the CPU is asked for) with a seeded
    generator: weights N(0, 0.02^2), norm weights 1 + N(0, 0.1^2) (gemma's,
    which scale by 1 + w, N(0, 0.1^2)), biases N(0, 0.02^2), all stored in
    `dtype`.  Tensors are drawn one at a time in `hf_shapes` order."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    centre = 0.0 if model_type == "gemma" else 1.0
    sd = {}
    for name, shape in hf_shapes(model_type, cfg).items():
        x = torch.randn(shape, generator=gen, device=dev)
        if len(shape) == 1 and "norm" in name and name.endswith("weight"):
            x = centre + 0.1 * x
        else:
            x = 0.02 * x
        sd[name] = x.to(dtype)
    return sd


# ---------------------------------------------------------------------------
# whisper
# ---------------------------------------------------------------------------


def whisper_large_v2_config() -> Dict[str, Any]:
    """openai/whisper-large-v2's config.json: the fields `convert_whisper`
    reads (and the decoder's, equal to the encoder's)."""
    return {
        "model_type": "whisper", "vocab_size": 51865, "d_model": 1280,
        "encoder_layers": 32, "decoder_layers": 32,
        "encoder_attention_heads": 20, "decoder_attention_heads": 20,
        "encoder_ffn_dim": 5120, "decoder_ffn_dim": 5120,
        "num_mel_bins": 80, "max_source_positions": 1500,
        "max_target_positions": 448, "decoder_start_token_id": 50258,
        "eos_token_id": 50257, "torch_dtype": "float32",
    }


def whisper_hf_shapes(hf: Dict[str, Any]) -> Dict[str, tuple]:
    """Tensor names and shapes of an HF `WhisperForConditionalGeneration`
    state dict (the token embedding tied to `proj_out`, which it omits)."""
    e, ff = hf["d_model"], hf["encoder_ffn_dim"]
    out: Dict[str, tuple] = {
        "model.encoder.conv1.weight": (e, hf["num_mel_bins"], 3),
        "model.encoder.conv1.bias": (e,),
        "model.encoder.conv2.weight": (e, e, 3),
        "model.encoder.conv2.bias": (e,),
        "model.encoder.embed_positions.weight": (
            hf["max_source_positions"], e),
    }

    def attn(p):
        for n in ("k_proj", "v_proj", "q_proj", "out_proj"):
            _linear(out, f"{p}.{n}", e, e, n != "k_proj")

    def block(p, cross):
        attn(p + ".self_attn")
        _norm(out, p + ".self_attn_layer_norm", e)
        if cross:
            attn(p + ".encoder_attn")
            _norm(out, p + ".encoder_attn_layer_norm", e)
        _linear(out, p + ".fc1", ff, e, True)
        _linear(out, p + ".fc2", e, ff, True)
        _norm(out, p + ".final_layer_norm", e)

    for i in range(hf["encoder_layers"]):
        block(f"model.encoder.layers.{i}", False)
    _norm(out, "model.encoder.layer_norm", e)
    out["model.decoder.embed_tokens.weight"] = (hf["vocab_size"], e)
    out["model.decoder.embed_positions.weight"] = (
        hf["max_target_positions"], e)
    for i in range(hf["decoder_layers"]):
        block(f"model.decoder.layers.{i}", True)
    _norm(out, "model.decoder.layer_norm", e)
    return out


def synth_whisper_state_dict(hf: Dict[str, Any], seed: int = 0,
                             device=None) -> Dict[str, torch.Tensor]:
    """A random float32 whisper checkpoint for the config `hf`, drawn on
    `device` (the card unless the CPU is asked for) with a seeded generator,
    one tensor at a time in `whisper_hf_shapes` order: LayerNorm weights
    1 + N(0, 0.1^2), everything else N(0, 0.02^2)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sd = {}
    for name, shape in whisper_hf_shapes(hf).items():
        x = torch.randn(shape, generator=gen, device=dev)
        norm_w = "layer_norm" in name and name.endswith("weight")
        sd[name] = 1.0 + 0.1 * x if norm_w else 0.02 * x
    return sd


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Write {name: tensor} as one `.safetensors` file (the format
    `convert.loaders.read_safetensors` reads: the header padded to a
    multiple of 8 bytes, the tensors' little-endian bytes in order).
    Tensors may lie on any device; each is copied to the host in turn."""
    from ..convert.loaders import _ST_DTYPES

    tags = {t_dt: tag for tag, (_, t_dt) in _ST_DTYPES.items()}
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": tags[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(t.detach().reshape(-1).view(torch.uint8).cpu().numpy())


def write_whisper_checkpoint(path: str, hf: Dict[str, Any], seed: int = 0,
                             device=None) -> int:
    """Draw `synth_whisper_state_dict` and write it to the directory `path`
    as `config.json` + `model.safetensors`.  Returns the file's bytes."""
    sd = synth_whisper_state_dict(hf, seed, device)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    st = os.path.join(path, "model.safetensors")
    write_safetensors(st, sd)
    return os.path.getsize(st)
