"""The port's float-checkpoint converter (`convert/hf.py`) against the JAX
package's, on tiny random-init `transformers` models built here (as
`tests/test_golden_hf.py` builds them): one per ported mapper, with and
without a `QSpec`.  Packs must be equal bit for bit (planes, scales), dense
leaves equal with equal dtypes, and the two packages' `ArchConfig`s equal.
Baichuan has no `transformers` class: its fused `W_pack` checkpoint is drawn
here as `tests/test_chatglm2.py` draws it.

`convert_model` on a tiny MPT directory written with `save_pretrained`
(safetensors) equals `params_from_state_dict` on the same state dict.
"""

import dataclasses

import numpy as np
import pytest
import torch

from neural_speed_tpu.convert import hf as JH
from neural_speed_tpu.models.configs import arch_from_hf_config as j_arch
from neural_speed_tpu.ops.qtypes import QSpec as JSpec, QType as JQType
from neural_speed_tpu_torch.convert import hf as TH
from neural_speed_tpu_torch.models.configs import arch_from_hf_config
from neural_speed_tpu_torch.ops.qtypes import QSpec, QType

from tests.torch_port_util import assert_tree_equal

torch.set_num_threads(1)

LLAMA_TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=128,
                  max_position_embeddings=128)


def _tf(name, **kw):
    """(model class, config) of `transformers` for a tiny `name`."""
    import transformers as tr

    builders = {
        "llama": lambda: (tr.LlamaForCausalLM, tr.LlamaConfig(
            **LLAMA_TINY, num_key_value_heads=2, tie_word_embeddings=False)),
        "mistral": lambda: (tr.MistralForCausalLM, tr.MistralConfig(
            **LLAMA_TINY, num_key_value_heads=2, sliding_window=None)),
        "mixtral": lambda: (tr.MixtralForCausalLM, tr.MixtralConfig(
            **LLAMA_TINY, num_key_value_heads=2, num_local_experts=4,
            num_experts_per_tok=2)),
        "qwen2": lambda: (tr.Qwen2ForCausalLM, tr.Qwen2Config(
            **LLAMA_TINY, num_key_value_heads=2)),
        "phi3": lambda: (tr.Phi3ForCausalLM, tr.Phi3Config(
            **LLAMA_TINY, num_key_value_heads=2, pad_token_id=0,
            bos_token_id=1, eos_token_id=2)),
        "gemma": lambda: (tr.GemmaForCausalLM, tr.GemmaConfig(
            **LLAMA_TINY, head_dim=16, num_key_value_heads=2,
            hidden_act="gelu_pytorch_tanh")),
        "stablelm": lambda: (tr.StableLmForCausalLM, tr.StableLmConfig(
            **LLAMA_TINY, num_key_value_heads=2, partial_rotary_factor=0.25)),
        "gptj": lambda: (tr.GPTJForCausalLM, tr.GPTJConfig(
            vocab_size=256, n_embd=64, n_layer=2, n_head=4, n_positions=128,
            rotary_dim=8)),
        "gptneox": lambda: (tr.GPTNeoXForCausalLM, tr.GPTNeoXConfig(
            **LLAMA_TINY, rotary_pct=0.25, use_parallel_residual=True)),
        "opt": lambda: (tr.OPTForCausalLM, tr.OPTConfig(
            vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, ffn_dim=128, max_position_embeddings=128,
            word_embed_proj_dim=64, do_layer_norm_before=True,
            activation_function="relu")),
        "bloom": lambda: (tr.BloomForCausalLM, tr.BloomConfig(
            vocab_size=256, hidden_size=64, n_layer=2, n_head=4)),
        "falcon": lambda: (tr.FalconForCausalLM, tr.FalconConfig(
            vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, multi_query=True,
            new_decoder_architecture=False, parallel_attn=True, bias=False,
            alibi=False)),
        "mpt": lambda: (tr.MptForCausalLM, tr.MptConfig(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            expansion_ratio=4, max_seq_len=128)),
        "starcoder": lambda: (tr.GPTBigCodeForCausalLM, tr.GPTBigCodeConfig(
            vocab_size=256, n_embd=64, n_layer=2, n_head=4, n_positions=128,
            multi_query=True, activation_function="gelu_pytorch_tanh")),
        "phi": lambda: (tr.PhiForCausalLM, tr.PhiConfig(
            **LLAMA_TINY, num_key_value_heads=4, partial_rotary_factor=0.5)),
    }
    cls, cfg = builders[name]()
    if name == "opt" and "initializer_range" in kw:
        kw["init_std"] = kw["initializer_range"]    # OPT's name for it
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cls, cfg


def _baichuan_sd(seed: int, scale: float = 0.02):
    """A baichuan-7B-shaped checkpoint (fused W_pack rows [q; k; v])."""
    hf = dict(model_type="baichuan", vocab_size=256, hidden_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=128, max_position_embeddings=128,
              rms_norm_eps=1e-6)
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g) * scale
    e, f = 64, 128
    sd = {"model.embed_tokens.weight": r(256, e),
          "model.norm.weight": 1 + r(e) * 5, "lm_head.weight": r(256, e)}
    for i in range(2):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": 1 + r(e) * 5,
                   p + "post_attention_layernorm.weight": 1 + r(e) * 5,
                   p + "self_attn.W_pack.weight": r(3 * e, e),
                   p + "self_attn.o_proj.weight": r(e, e),
                   p + "mlp.gate_proj.weight": r(f, e),
                   p + "mlp.up_proj.weight": r(f, e),
                   p + "mlp.down_proj.weight": r(e, f)})
    return hf, sd


MAPPERS = ["llama", "mistral", "mixtral", "qwen2", "phi3", "gemma",
           "stablelm", "baichuan", "gptj", "gptneox", "opt", "bloom",
           "falcon", "mpt", "starcoder", "phi"]


def hf_checkpoint(name: str, seed: int = 0, **cfg_kw):
    """(config dict, float32 state dict) of the tiny `name` model, its
    weights drawn by `transformers`' own init under `seed`."""
    if name == "baichuan":
        return _baichuan_sd(seed, cfg_kw.get("initializer_range", 0.02))
    cls, config = _tf(name, **cfg_kw)
    torch.manual_seed(seed)
    with torch.no_grad():
        m = cls(config)
    return config.to_dict(), {k: v.detach().clone()
                              for k, v in m.state_dict().items()}


def _specs(group):
    return (JSpec(JQType.INT, 4, group, True, scale_dtype="bfloat16"),
            QSpec(QType.INT, 4, group, True, scale_dtype="bfloat16"))


def assert_archs_equal(jcfg, tcfg):
    j, t = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    assert j == t


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int4-g32"])
@pytest.mark.parametrize("name", MAPPERS)
def test_converter_matches_jax(name, quant):
    hf, sd = hf_checkpoint(name)
    jcfg, tcfg = j_arch(hf), arch_from_hf_config(hf)
    assert_archs_equal(jcfg, tcfg)
    jspec, tspec = _specs(32) if quant else (None, None)
    jp = JH.params_from_state_dict(sd, jcfg, jspec)
    tp = TH.params_from_state_dict(sd, tcfg, tspec, device="cpu")
    assert_tree_equal(jp, tp)


def test_projections_stay_dense_where_the_group_does_not_divide_k():
    """As Falcon-7B's K = 4544 at g = 128: both converters keep such
    projections dense (bf16) and pack the others.  Here a Falcon of hidden
    384 = 3 * 128: at g = 128 everything packs; at g = 256 the projections
    over the hidden width stay dense, the 4x-wide down projection packs."""
    from neural_speed_tpu_torch.ops.quantize import QTensor

    hf, sd = hf_checkpoint("falcon", hidden_size=384, num_attention_heads=6)
    cfg = arch_from_hf_config(hf)
    for group, dense in ((128, False), (256, True)):
        jspec, tspec = _specs(group)
        tp = TH.params_from_state_dict(sd, cfg, tspec, device="cpu")
        assert_tree_equal(JH.params_from_state_dict(sd, j_arch(hf), jspec),
                          tp)
        lp = tp["layers"][0]
        q = lp["q"]["w"]
        assert (q.dtype == torch.bfloat16) if dense else isinstance(
            q, QTensor)
        assert isinstance(lp["ffn"]["down"]["w"], QTensor)


def test_convert_model_reads_a_float_directory(tmp_path):
    from neural_speed_tpu_torch.convert import convert_model
    from neural_speed_tpu_torch.convert.loaders import load_state_dict

    cls, config = _tf("mpt")
    torch.manual_seed(3)
    with torch.no_grad():
        m = cls(config)
    m.save_pretrained(str(tmp_path), safe_serialization=True)
    _, tspec = _specs(32)
    params, cfg = convert_model(str(tmp_path), tspec, device="cpu")
    assert cfg == arch_from_hf_config(config.to_dict())
    sd = load_state_dict(str(tmp_path))
    want = TH.params_from_state_dict(sd, cfg, tspec, device="cpu")
    jp = JH.params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, j_arch(config.to_dict()),
        _specs(32)[0])
    assert_tree_equal(jp, params)
    flat = lambda t: [x for x in torch.utils._pytree.tree_leaves(t)]
    assert len(flat(want)) == len(flat(params))


def test_unported_mappers_and_policy():
    """chatglm2 / qwen / grok have no mapper yet; a per-path policy
    quantizes after a float32 mapping, as in the JAX package."""
    with pytest.raises(ValueError, match="no state-dict mapper"):
        TH.params_from_state_dict({}, dataclasses.replace(
            arch_from_hf_config(hf_checkpoint("llama")[0]), name="chatglm2"))
    hf, sd = hf_checkpoint("llama")
    jspec, tspec = _specs(32)
    jp = JH.params_from_state_dict(
        sd, j_arch(hf), policy=lambda path: None if "ffn" in path else jspec)
    tp = TH.params_from_state_dict(
        sd, arch_from_hf_config(hf), device="cpu",
        policy=lambda path: None if "ffn" in path else tspec)
    assert_tree_equal(jp, tp)
