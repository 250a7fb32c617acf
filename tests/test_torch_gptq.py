"""GPTQ / AWQ ingestion of the PyTorch port against the JAX package.

The checkpoints are drawn in the published layouts (AutoGPTQ's `qweight`,
`qzeros`, `scales`, `g_idx`; AWQ's interleaved columns) as
`tests/test_gptq.py` builds them.  Held:

* the unpackers, the packers and `gptq_to_qtensor` bit for bit (planes,
  zero points, scales, the act-order `perm`) for GPTQ v1 and v2, AWQ,
  act-order, bits 2/3/4/8 and bf16 scales;
* `params_from_quantized_state_dict` on a 2-layer llama, leaf for leaf;
* a tiny act-order GPTQ llama through the JAX `Engine` and the port's
  `Engine` and `PagedEngine` on the CPU: logits within LOGIT_TOL and
  identical greedy ids, with the top-2 margin above LOGIT_TOL at every
  step.  The perm'd projections do not fuse, so each runs its own gather.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.convert import gptq as JG
from neural_speed_tpu.models.arch import ArchConfig as JArchConfig
from neural_speed_tpu.runtime.engine import Engine as JEngine
from neural_speed_tpu_torch.convert import gptq as TG
from neural_speed_tpu_torch.models.arch import ArchConfig
from neural_speed_tpu_torch.runtime.engine import Engine, PagedEngine

from tests.torch_port_util import assert_qtensor_equal, assert_tree_equal

torch.set_num_threads(1)

K, N, G = 128, 64, 32


def _make_gptq(seed=0, bits=4, act_order=False, awq=False, k=K, n=N, g=G,
               scale=0.1):
    """A random weight quantized into GPTQ / AWQ tensor layout (the
    fixture of tests/test_gptq.py at any shape): (qweight, qzeros, scales,
    g_idx)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * scale
    groups = k // g
    g_idx = np.repeat(np.arange(groups), g)
    if act_order:
        g_idx = rng.permutation(g_idx)
    maxc = (1 << bits) - 1
    scales = np.zeros((groups, n), np.float32)
    zeros = np.zeros((groups, n), np.int32)
    codes = np.zeros((k, n), np.uint8)
    for gi in range(groups):
        rows = np.where(g_idx == gi)[0]
        wg = w[rows]
        mn, mx = wg.min(0), wg.max(0)
        sc = np.maximum((mx - mn) / maxc, 1e-8)
        zp = np.clip(np.round(-mn / sc), 0, maxc)
        scales[gi] = sc
        zeros[gi] = zp
        codes[rows] = np.clip(np.round(wg / sc) + zp, 0, maxc).astype(
            np.uint8)
    if awq:
        qweight = JG.pack_cols(codes, bits, awq=True).astype(np.int32)
        qzeros = JG.pack_cols(zeros.astype(np.uint8), bits, awq=True)
    else:
        qweight = JG.pack_rows(codes, bits)
        # v1 convention stores zp - 1
        qzeros = JG.pack_cols((zeros - 1).astype(np.uint8) & maxc, bits)
    return qweight, qzeros, scales, g_idx


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_unpackers_and_packers_bit_for_bit(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, (320, 80)).astype(np.uint8)
    rows = JG.pack_rows(codes[: 32 // bits * 10], bits)
    np.testing.assert_array_equal(TG.pack_rows(codes[: 32 // bits * 10],
                                               bits).numpy(), rows)
    np.testing.assert_array_equal(TG.unpack_rows(rows, bits).numpy(),
                                  JG.unpack_rows(rows, bits))
    for awq in (False, True):
        cols = JG.pack_cols(codes[:, : 32 // bits * 8], bits, awq=awq)
        np.testing.assert_array_equal(
            TG.pack_cols(codes[:, : 32 // bits * 8], bits, awq=awq).numpy(),
            cols)
        got = TG.unpack_cols(torch.from_numpy(cols), bits, awq=awq)
        np.testing.assert_array_equal(got.numpy(),
                                      JG.unpack_cols(cols, bits, awq=awq))


def _assert_same(jres, tres):
    jqt, jperm = jres
    tqt, tperm = tres
    assert_qtensor_equal(jqt, tqt)
    assert (jperm is None) == (tperm is None)
    if jperm is not None:
        assert tperm.dtype == torch.int32
        np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))


@pytest.mark.parametrize("bits,variant", [
    (b, v) for b in (2, 3, 4, 8)
    for v in ("v1", "v2", "awq", "act-order", "bf16-scales")
    if v != "awq" or b == 4])                 # AWQ checkpoints are 4-bit
def test_gptq_to_qtensor_bit_for_bit(bits, variant):
    # 3-bit words pack 10 codes, along K (qweight) and along N (qzeros)
    k, n, g = (320, 80, 64) if bits == 3 else (K, N, G)
    awq = variant == "awq"
    qw, qz, sc, gi = _make_gptq(seed=bits, bits=bits, awq=awq, k=k, n=n,
                                g=g, act_order=variant == "act-order")
    kw = dict(bits=bits, awq=awq, zero_plus_one=variant not in ("v2", "awq"),
              scale_dtype="bfloat16" if variant == "bf16-scales" else
              "float32")
    g_idx = None if awq else gi
    want = JG.gptq_to_qtensor(qw, qz, sc, g_idx=g_idx, **kw)
    got = TG.gptq_to_qtensor(torch.from_numpy(qw), torch.from_numpy(qz),
                             torch.from_numpy(sc),
                             None if g_idx is None else torch.from_numpy(
                                 g_idx), **kw)
    _assert_same(want, got)
    # numpy inputs and float16 scales (as AutoGPTQ stores them) as well
    sc16 = sc.astype(np.float16)
    _assert_same(JG.gptq_to_qtensor(qw, qz, sc16, g_idx=g_idx, **kw),
                 TG.gptq_to_qtensor(qw, qz, sc16, g_idx=g_idx, **kw))


def test_detect_quant_method_matches():
    for qc in ({}, {"quant_method": "awq", "bits": 4},
               {"quant_method": "gptq", "checkpoint_format": "gptq_v2",
                "desc_act": True, "bits": 8},
               {"quant_method": "gptq", "bits": 3}):
        hf = {"quantization_config": qc}
        assert TG.detect_quant_method(hf) == JG.detect_quant_method(hf)
    assert TG.is_quantized_state_dict({"a.qweight": 0})
    assert not TG.is_quantized_state_dict({"a.weight": 0})


# a tiny llama: hidden 256, 8 query heads over 4 KV heads, FFN 512
CFG = dict(name="llama", vocab_size=256, hidden_size=256, n_layers=2,
           n_heads=8, n_kv_heads=4, intermediate_size=512,
           max_position_embeddings=256)
PROJ = [("self_attn.q_proj", 256, 256), ("self_attn.k_proj", 256, 128),
        ("self_attn.v_proj", 256, 128), ("self_attn.o_proj", 256, 256),
        ("mlp.gate_proj", 256, 512), ("mlp.up_proj", 256, 512),
        ("mlp.down_proj", 512, 256)]


def _state_dict(seed: int, n_layers: int = 2):
    """An act-order GPTQ v1 llama state dict (int4, g = 32), float16
    scales as AutoGPTQ writes them, float32 embedding, norms and head."""
    rng = np.random.default_rng(seed)
    v, h = CFG["vocab_size"], CFG["hidden_size"]
    sd = {"model.embed_tokens.weight":
          rng.standard_normal((v, h)).astype(np.float32),
          "model.norm.weight": rng.uniform(0.8, 1.2, h).astype(np.float32),
          "lm_head.weight":
          rng.standard_normal((v, h)).astype(np.float32) * 0.1}
    for i in range(n_layers):
        pre = f"model.layers.{i}."
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[pre + norm + ".weight"] = rng.uniform(0.8, 1.2, h).astype(
                np.float32)
        for j, (name, k, n) in enumerate(PROJ):
            qw, qz, sc, gi = _make_gptq(seed * 1000 + i * 10 + j, 4, True,
                                        k=k, n=n, g=32, scale=0.08)
            sd[pre + name + ".qweight"] = qw
            sd[pre + name + ".qzeros"] = qz
            sd[pre + name + ".scales"] = sc.astype(np.float16)
            sd[pre + name + ".g_idx"] = gi.astype(np.int32)
    return sd


HF_CFG = {"model_type": "llama", "quantization_config": {
    "quant_method": "gptq", "bits": 4, "group_size": 32, "desc_act": True}}


def test_params_from_quantized_state_dict_leaf_for_leaf():
    from neural_speed_tpu_torch.models.configs import arch_from_hf_config

    sd = _state_dict(3)
    jp = JG.params_from_quantized_state_dict(sd, JArchConfig(**CFG), HF_CFG)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    tp = TG.params_from_quantized_state_dict(tsd, ArchConfig(**CFG), HF_CFG)
    assert_tree_equal(jp, tp)
    assert "perm" in tp["layers"][1]["ffn"]["down"]
    cfg = arch_from_hf_config(dict(HF_CFG, vocab_size=256, hidden_size=256,
                                   num_hidden_layers=2,
                                   num_attention_heads=8,
                                   num_key_value_heads=4,
                                   intermediate_size=512))
    assert (cfg.n_layers, cfg.n_kv_heads, cfg.moe) == (2, 4, None)


def test_arch_from_hf_config_refuses_unported_archs():
    from neural_speed_tpu_torch.models.configs import arch_from_hf_config

    with pytest.raises(NotImplementedError, match="item 1"):
        arch_from_hf_config({"model_type": "qwen"})
    with pytest.raises(NotImplementedError, match="item 1: chatglm"):
        arch_from_hf_config({"model_type": "chatglm2"})
    grok = arch_from_hf_config({
        "model_type": "grok-1", "vocab_size": 256, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 6, "num_key_value_heads": 1})
    assert (grok.logit_softcap, grok.act, grok.post_attn_norm) == (
        30.0, "gelu_tanh", True)
    with pytest.raises(ValueError, match="unsupported"):
        arch_from_hf_config({"model_type": "no-such-arch"})


# logits within 0.15 (about 5 bf16 ulps at |logit| ~ 5): bf16 activations
# summed in another order and, at decode, exact float32 weights in the port
# where the JAX CPU path rounds them to bf16 (measured at most 0.13 over
# params seeds 200-259); the seed keeps every greedy step's top-2 margin
# above that (at least 0.156 over the 8 steps)
LOGIT_TOL = 0.15
SEED = 238
PROMPTS = [[5, 9, 2, 44, 17, 3, 8, 1, 200], [7, 7, 100, 3],
           [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23]]
ACTIVE = np.array([True, False, True])


@pytest.mark.parametrize("paged", [False, True])
def test_act_order_llama_greedy_matches_jax(paged, monkeypatch):
    monkeypatch.setenv("NST_FLASH", "off")
    sd = _state_dict(SEED)
    jcfg = JArchConfig(**CFG, kv_append="plain")
    je = JEngine(JG.params_from_quantized_state_dict(sd, jcfg, HF_CFG), jcfg,
                 max_batch=3, max_len=128, kv_quantized=True)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    tcfg = ArchConfig(**CFG, kv_append="plain")
    tp = TG.params_from_quantized_state_dict(tsd, tcfg, HF_CFG)
    if paged:
        pe = PagedEngine(tp, tcfg, max_batch=3, max_len=128,
                         kv_quantized=True, page_size=16, n_pages=24,
                         device="cpu")
    else:
        pe = Engine(tp, tcfg, max_batch=3, max_len=128, kv_quantized=True,
                    device="cpu")
    # act-order: nothing fuses, every projection keeps its gather
    lp = pe.params["layers"][0]
    assert "qkv" not in lp and "gateup" not in lp["ffn"]
    assert all("perm" in lp[n] for n in ("q", "k", "v", "o"))
    jl = np.asarray(je.prefill(PROMPTS), np.float32)
    pl = pe.prefill(PROMPTS).numpy()
    for step in range(8):
        np.testing.assert_allclose(pl[ACTIVE], jl[ACTIVE], rtol=0,
                                   atol=LOGIT_TOL)
        top2 = np.sort(jl[ACTIVE], axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > LOGIT_TOL), step
        jid, pid = jl.argmax(-1), pl.argmax(-1)
        np.testing.assert_array_equal(pid[ACTIVE], jid[ACTIVE])
        jl = np.asarray(je.decode(jnp.asarray(jid, jnp.int32),
                                  jnp.asarray(ACTIVE)), np.float32)
        pl = pe.decode(torch.from_numpy(pid.astype(np.int32)),
                       torch.from_numpy(ACTIVE)).numpy()
