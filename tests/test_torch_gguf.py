"""The GGUF tensor path of the PyTorch port against the JAX package.

* each decoder of `DECODERS` bit for bit (codes, scales, offsets) on random
  block bytes (every bit pattern, NaN / inf fp16 fields included) and on
  bytes from the JAX package's encoder;
* `gguf_tensor_to_qtensor` (planes, scales, offsets bit for bit) and
  `gguf_tensor_to_array` (F32 / F16 / quantized) through a file;
* the port's `GGUFWriter` writes the JAX writer's bytes;
* files written by the JAX package's `write_hf_to_gguf` (llama at Q4_0,
  Q8_0, Q4_K and Q2_K; mixtral at Q4_0), loaded by both `load_gguf_model`s
  into equal params, and served by both `Engine`s on the CPU: logits
  within the stated tolerance and identical greedy ids, with the top-2
  margin above it at every step (and, for the Mixtral, every routing decision of
  a real token clear of a tie, as tests/test_torch_moe_model.py holds it).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.convert import gguf as JG
from neural_speed_tpu.runtime.engine import Engine as JEngine
from neural_speed_tpu_torch.convert import gguf as TG
from neural_speed_tpu_torch.runtime.engine import Engine

from tests.torch_port_util import (assert_qtensor_equal, assert_tree_equal,
                                   bf16_to_f32, to_numpy, torch_to_numpy)

torch.set_num_threads(1)

TYPES = sorted(JG.DECODERS)


def _random_blocks(ttype, rows, row_len, seed):
    be, bb = JG.ggml_block_info(ttype)
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, rows * row_len // be * bb).astype(np.uint8)


def _assert_decoded(want, got):
    for w, g, name in zip(want, got, ("codes", "scales", "offsets")):
        assert (w is None) == (g is None), name
        if w is not None:
            g = g.numpy()
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("ttype", TYPES)
def test_decoders_bit_for_bit_on_random_blocks(ttype):
    raw = _random_blocks(ttype, 6, 512, ttype)
    dec = JG.DECODERS[ttype][0]
    _assert_decoded(dec(raw, 6, 512),
                    TG.DECODERS[ttype][0](torch.from_numpy(raw), 6, 512))
    assert TG.DECODERS[ttype][1:] == JG.DECODERS[ttype][1:]


@pytest.mark.parametrize("ttype", [JG.GGML_Q4_0, JG.GGML_Q8_0, JG.GGML_Q4_K,
                                   JG.GGML_Q5_K, JG.GGML_Q2_K, JG.GGML_Q3_K])
def test_decoders_bit_for_bit_on_encoded_blocks(ttype):
    w = np.random.default_rng(1).standard_normal((8, 512)).astype(np.float32)
    raw = np.frombuffer(JG.encode_ggml(w, ttype), np.uint8)
    dec = JG.DECODERS[ttype][0]
    _assert_decoded(dec(raw, 8, 512), TG.DECODERS[ttype][0](raw, 8, 512))


@pytest.mark.parametrize("ttype", TYPES)
def test_tensor_to_qtensor_bit_for_bit(ttype):
    raw = _random_blocks(ttype, 16, 512, 100 + ttype)
    # the JAX path decodes numpy bytes; the port's runs on a uint8 tensor
    want = JG.gguf_tensor_to_qtensor(raw, (512, 16), ttype)
    got = TG.gguf_tensor_to_qtensor(torch.from_numpy(raw), (512, 16), ttype)
    assert_qtensor_equal(want, got)


def _write_both(tmp_path, tensors, kv):
    """The same metadata and block bytes through both writers."""
    paths = []
    for mod, name in ((JG, "jax.gguf"), (TG, "port.gguf")):
        w = mod.GGUFWriter(str(tmp_path / name))
        for k, v in kv:
            w.add(k, v)
        for tname, shape, ttype, raw in tensors:
            w.add_tensor(tname, np.empty(shape, np.uint8), ttype,
                         raw=raw.tobytes() if mod is JG else raw)
        w.write()
        paths.append(str(tmp_path / name))
    return paths


def test_writer_and_tensor_to_array(tmp_path):
    rng = np.random.default_rng(3)
    tensors = [("f32", (4, 32), JG.GGML_F32,
                rng.standard_normal((4, 32)).astype(np.float32).view(
                    np.uint8).reshape(-1)),
               ("f16", (3, 64), JG.GGML_F16,
                rng.standard_normal((3, 64)).astype(np.float16).view(
                    np.uint8).reshape(-1))]
    for ttype in TYPES:
        w = rng.standard_normal((2, 256)).astype(np.float32)
        raw = (np.frombuffer(JG.encode_ggml(w, ttype), np.uint8)
               if ttype in (JG.GGML_Q4_0, JG.GGML_Q8_0, JG.GGML_Q4_K,
                            JG.GGML_Q2_K)
               else _random_blocks(ttype, 2, 256, ttype))
        tensors.append((f"q{ttype}", (2, 256), ttype, raw))
    kv = [("general.architecture", "llama"), ("llama.block_count", 2),
          ("general.name", "t"), ("x.f", 0.5), ("x.list", [1, 2, 3]),
          ("x.strs", ["a", "bc"]), ("x.flag", True)]
    jpath, tpath = _write_both(tmp_path, tensors, kv)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    jr, tr = JG.GGUFReader(tpath), TG.GGUFReader(tpath)
    assert tr.kv == jr.kv and tr.tensors == {
        k: TG.GGUFTensorInfo(*v.__dict__.values())
        for k, v in jr.tensors.items()}
    for name, info in jr.tensors.items():
        for dt_j, dt_t in ((jnp.float32, torch.float32),
                           (jnp.bfloat16, torch.bfloat16)):
            want = to_numpy(JG.gguf_tensor_to_array(jr, info, dt_j))
            got = torch_to_numpy(TG.gguf_tensor_to_array(
                tr, tr.tensors[name], dt_t, device="cpu"))
            if dt_t == torch.bfloat16:
                # random fp16 fields decode to NaNs, whose bf16 payloads
                # differ between the frameworks: compare values
                got, want = bf16_to_f32(got), bf16_to_f32(want)
            np.testing.assert_array_equal(got, want, err_msg=name)
    with pytest.raises(NotImplementedError, match="item 8"):
        TG.GGUFWriter(str(tmp_path / "x.gguf")).add_tensor(
            "w", np.zeros((2, 32)), JG.GGML_Q4_0)


# tiny models: hidden 256 (the K-quants' 256-element super-blocks), 8 query
# heads over 4 KV heads (2 for the Mixtral: its n_rep = 4), FFN 512
HF = dict(vocab_size=256, hidden_size=256, num_hidden_layers=2,
          num_attention_heads=8, num_key_value_heads=4, intermediate_size=512,
          max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0)
HF_MOE = dict(HF, model_type="mixtral", vocab_size=128, num_key_value_heads=2,
              num_local_experts=4, num_experts_per_tok=2)


def _state_dict(hf, seed):
    """A llama / mixtral HF state dict in torch's [out, in] layout, drawn so
    that greedy steps have clear margins: unit-normal embeddings, projections
    of std 0.08, a head of std 0.1."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sd=0.08: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * sd)
    h, inter, v = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    kv = h // hf["num_attention_heads"] * hf["num_key_value_heads"]
    norm = lambda: torch.from_numpy(rng.uniform(0.8, 1.2, h).astype(
        np.float32))
    sd = {"model.embed_tokens.weight": f(v, h, sd=1.0),
          "model.norm.weight": norm(), "lm_head.weight": f(v, h, sd=0.1)}
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = norm()
        sd[p + "post_attention_layernorm.weight"] = norm()
        for name, n in (("q_proj", h), ("k_proj", kv), ("v_proj", kv),
                        ("o_proj", h)):
            sd[p + f"self_attn.{name}.weight"] = f(n, h)
        if hf.get("model_type") == "mixtral":
            sd[p + "block_sparse_moe.gate.weight"] = f(
                hf["num_local_experts"], h, sd=1.0)
            for e in range(hf["num_local_experts"]):
                ep = p + f"block_sparse_moe.experts.{e}."
                sd[ep + "w1.weight"] = f(inter, h)
                sd[ep + "w3.weight"] = f(inter, h)
                sd[ep + "w2.weight"] = f(h, inter)
        else:
            sd[p + "mlp.gate_proj.weight"] = f(inter, h)
            sd[p + "mlp.up_proj.weight"] = f(inter, h)
            sd[p + "mlp.down_proj.weight"] = f(h, inter)
    return sd


def _files(tmp_path, hf, seed, ttype):
    path = str(tmp_path / "m.gguf")
    JG.write_hf_to_gguf(_state_dict(hf, seed), dict(
        {"model_type": "llama"}, **hf), path, ggml_type=ttype)
    jp, jcfg, _ = JG.load_gguf_model(path)
    tp, tcfg, tok = TG.load_gguf_model(path, device="cpu")
    assert tok is None
    return jp, jcfg, tp, tcfg


@pytest.mark.parametrize("hf,ttype", [(HF, JG.GGML_Q4_0), (HF, JG.GGML_Q8_0),
                                      (HF, JG.GGML_Q4_K),
                                      (HF_MOE, JG.GGML_Q4_0)],
                         ids=["llama-Q4_0", "llama-Q8_0", "llama-Q4_K",
                              "mixtral-Q4_0"])
def test_load_gguf_model_equal_params(tmp_path, hf, ttype):
    jp, jcfg, tp, tcfg = _files(tmp_path, hf, 0, ttype)
    assert tcfg == type(tcfg)(**{k: getattr(jcfg, k) if k != "moe" else
                                 tcfg.moe for k in tcfg.__dataclass_fields__})
    if jcfg.moe is not None:
        assert (tcfg.moe.num_experts, tcfg.moe.top_k) == (
            jcfg.moe.num_experts, jcfg.moe.top_k)
    assert_tree_equal(jp, tp)


def test_gguf_arch_refusals(tmp_path):
    """Archs whose knobs are not ported raise; a `llama` file carrying
    `ffn_gate_inp` fails in both packages (its config has no MoE section:
    the JAX package's behaviour, mirrored)."""
    kv = {"general.architecture": "falcon", "falcon.attention.head_count": 4}
    with pytest.raises(NotImplementedError, match="item 1"):
        TG._arch_from_gguf(kv)
    path = str(tmp_path / "m.gguf")
    JG.write_hf_to_gguf(_state_dict(HF, 0), dict(HF, model_type="llama"),
                        path, ggml_type=JG.GGML_Q8_0)
    # the same file with a router tensor added to its first layer
    w = JG.GGUFWriter(str(tmp_path / "quirk.gguf"))
    r = JG.GGUFReader(path)
    for k, v in r.kv.items():
        w.add(k, v)
    for name, info in r.tensors.items():
        w.add_tensor(name, np.empty(info.shape[::-1], np.uint8),
                     info.ggml_type, raw=r.tensor_bytes(info).tobytes())
    gate = np.zeros((4, 256), np.float32)
    w.add_tensor("blk.0.ffn_gate_inp.weight", gate, JG.GGML_F32,
                 raw=gate.tobytes())
    w.write()
    for load in (JG.load_gguf_model,
                 lambda p: TG.load_gguf_model(p, device="cpu")):
        with pytest.raises(AttributeError):
            load(str(tmp_path / "quirk.gguf"))


# (params seed, logit tolerance) per model: bf16 activations summed in
# another order, exact float32 weights at decode in the port against bf16
# ones in the JAX CPU path (measured at most 0.11 for the llamas, 0.14 for
# the Mixtral, whose rare larger gaps come from experts amplifying them;
# 0.2 as tests/test_torch_moe_model.py); each seed keeps every checked
# step's top-2 margin above its tolerance (searched on the CPU)
MODELS = {"llama-Q4_0": (34, 0.15), "llama-Q8_0": (13, 0.15),
          "llama-Q4_K": (19, 0.15), "llama-Q2_K": (6, 0.15),
          "mixtral-Q4_0": (282, 0.2)}
PROMPTS = [[5, 9, 2, 44, 17, 3, 8, 1, 100], [7, 7, 100, 3],
           [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23]]
ACTIVE = np.array([True, False, True])
STEPS = 6


@pytest.mark.parametrize("name,hf,ttype", [
    ("llama-Q4_0", HF, JG.GGML_Q4_0), ("llama-Q8_0", HF, JG.GGML_Q8_0),
    ("llama-Q4_K", HF, JG.GGML_Q4_K), ("llama-Q2_K", HF, JG.GGML_Q2_K),
    ("mixtral-Q4_0", HF_MOE, JG.GGML_Q4_0)])
def test_gguf_model_greedy_matches_jax(tmp_path, name, hf, ttype,
                                       monkeypatch):
    from tests.test_torch_moe_model import RouterMargins

    monkeypatch.setenv("NST_FLASH", "interpret")
    seed, tol = MODELS[name]
    jp, jcfg, tp, tcfg = _files(tmp_path, hf, seed, ttype)
    je = JEngine(jp, jcfg, max_batch=3, max_len=128, kv_quantized=True)
    pe = Engine(tp, tcfg, max_batch=3, max_len=128, kv_quantized=True,
                device="cpu")
    margins = RouterMargins(monkeypatch) if tcfg.moe is not None else None
    lens = [len(p) for p in PROMPTS]
    if margins:
        margins.rows = lambda shape: (torch.arange(shape[1])[None]
                                      < torch.tensor(lens)[:, None])
    jl = np.asarray(je.prefill(PROMPTS), np.float32)
    pl = pe.prefill(PROMPTS).numpy()
    if margins:
        margins.rows = lambda shape: torch.from_numpy(ACTIVE)[:, None]
    for step in range(STEPS):
        np.testing.assert_allclose(pl[ACTIVE], jl[ACTIVE], rtol=0,
                                   atol=tol, err_msg=f"step {step}")
        top2 = np.sort(jl[ACTIVE], axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > tol), step
        jid, pid = jl.argmax(-1), pl.argmax(-1)
        np.testing.assert_array_equal(pid[ACTIVE], jid[ACTIVE])
        jl = np.asarray(je.decode(jnp.asarray(jid, jnp.int32),
                                  jnp.asarray(ACTIVE)), np.float32)
        pl = pe.decode(torch.from_numpy(pid.astype(np.int32)),
                       torch.from_numpy(ACTIVE)).numpy()
    if margins:
        assert margins.worst > 1.0
