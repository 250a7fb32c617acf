"""A tiny llama in every weight-format family through `Engine` in both
packages (the port on the CPU, with its plain versions; JAX on the CPU).

Six configurations of one 2-layer, hidden-256 model (g = 128, so the
K-repad takes K = 256 to the pack period x 128: 1024 for one 4-bit plane,
4096 where a 1-bit plane sets it):

* nf4; int5 asymmetric; fp8_e4m3: the JAX package's synthetic params of
  that `QSpec`, carried across with `params_from_numpy`;
* int4 and int3 with int8 compute (`Engine(comp="int8")`; the JAX side reads
  `NST_COMP`, set here with monkeypatch): prefill steps of >= 32 rows go
  through `qmatmul_int8`, decode through `qmatmul`;
* a mixed quant-config policy (int4 by default, int8 `ffn.down`, nf4 `o`,
  a float `lm_head`): dense weights from a numpy seed, quantized by the JAX
  package's `quantize_tree`, carried across.

Checked, after a ragged prefill of 3 prompts and at each of 4 greedy decode
steps (slot 1 a spectator): logits within REL_TOL = 6 bf16 ulps (6 * 2**-8)
of the largest |logit| of the JAX side, for the reasons given in
`test_torch_model.py` (bf16 rounding of activations and of the head's
output, the port's float32 decode weights where `qmatmul_xla` rounds them to
bf16; with int8 compute, an activation that quantizes to the neighbouring
int8 code on one side); greedy ids identical, with the JAX side's top-2
margin above that tolerance at every step so that equality is not a coin
toss.  The params' seeds are ones whose greedy streams keep that margin.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_speed_tpu.convert.quant_config import (
    load_quant_config as jax_load_quant_config)
from neural_speed_tpu.models.arch import ArchConfig as JArchConfig
from neural_speed_tpu.ops.qtypes import named_qspec as jax_named_qspec
from neural_speed_tpu.runtime.engine import Engine as JEngine
from neural_speed_tpu.utils.synthetic import synth_params as jax_synth_params
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch.models.arch import ArchConfig
from neural_speed_tpu_torch.models.params import params_from_numpy
from neural_speed_tpu_torch.ops.quantize import QTensor
from neural_speed_tpu_torch.runtime.engine import Engine

from tests.torch_port_util import tree_to_numpy

# `neural_speed_tpu.ops` re-exports a function named `quantize`
jq = importlib.import_module("neural_speed_tpu.ops.quantize")

torch.set_num_threads(1)

REL_TOL = 6 * 2.0 ** -8
CFG = dict(name="llama", vocab_size=384, hidden_size=256, n_layers=2,
           n_heads=8, n_kv_heads=4, intermediate_size=512,
           max_position_embeddings=256)
PROMPTS = [[5, 9, 2, 44, 17, 3, 8, 1, 200],
           [7, 7, 100, 3],
           [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23]]
ACTIVE = np.array([True, False, True])
STEPS = 4

POLICY = {"default": {"weight_dtype": "int4", "group_size": 128,
                      "scale_dtype": "bf16"},
          "overrides": [
              {"pattern": r"ffn\.down$", "weight_dtype": "int8",
               "group_size": 128},
              {"pattern": r"\.o$", "weight_dtype": "nf4", "group_size": 128},
              {"pattern": "lm_head", "weight_dtype": "fp32"}]}

# name -> (dtype, symmetric, comp, params seed)
CONFIGS = {
    "nf4": ("nf4", True, None, 22),
    "int5-asym": ("int5", False, None, 113),
    "fp8_e4m3": ("fp8_e4m3", True, None, 8),
    "int4-comp-int8": ("int4", True, "int8", 3),
    "int3-comp-int8": ("int3", True, "int8", 0),
    "mixed-policy": (None, True, None, 21),
}


def _dense_params(seed):
    rng = np.random.default_rng(seed)
    e, f, v = CFG["hidden_size"], CFG["intermediate_size"], CFG["vocab_size"]
    kv = e // CFG["n_heads"] * CFG["n_kv_heads"]
    mat = lambda k, n: {"w": (rng.standard_normal((k, n)) * 0.06).astype(
        np.float32)}
    ones = lambda: {"weight": np.ones((e,), np.float32)}
    emb = (rng.standard_normal((v, e)) * 0.5).astype(np.float32)
    return {
        "embed": {"weight": jnp.asarray(emb).astype(jnp.bfloat16)},
        "layers": [{"attn_norm": ones(), "ffn_norm": ones(),
                    "q": mat(e, e), "k": mat(e, kv), "v": mat(e, kv),
                    "o": mat(e, e),
                    "ffn": {"gate": mat(e, f), "up": mat(e, f),
                            "down": mat(f, e)}}
                   for _ in range(CFG["n_layers"])],
        "final_norm": ones(), "lm_head": mat(e, v)}


def jax_params(name, seed):
    dtype, sym, _, _ = CONFIGS[name]
    jcfg = JArchConfig(**CFG)
    if dtype is None:
        dense = jax.tree_util.tree_map(jnp.asarray, _dense_params(seed))
        return jq.quantize_tree(dense, jax_load_quant_config(POLICY))
    return jax_synth_params(
        jcfg, jax_named_qspec(dtype, 128, sym, scale_dtype="bfloat16"),
        seed=seed)


def engines(name, seed, monkeypatch):
    comp = CONFIGS[name][2]
    monkeypatch.setenv("NST_FLASH", "off")
    if comp:
        monkeypatch.setenv("NST_COMP", comp)
    else:
        monkeypatch.delenv("NST_COMP", raising=False)
    jp = jax_params(name, seed)
    je = JEngine(jp, JArchConfig(**CFG, kv_append="plain"), max_batch=3,
                 max_len=128, kv_quantized=True)
    pe = Engine(params_from_numpy(tree_to_numpy(jp), device="cpu"),
                ArchConfig(**CFG, kv_append="plain"), max_batch=3, max_len=128,
                kv_quantized=True, device="cpu", comp=comp)
    return je, pe


def greedy_run(je, pe):
    """Prefill + STEPS greedy steps in both engines, each following its own
    argmax.  Returns per step (largest |logit difference| / tolerance,
    JAX top-2 margin / tolerance, ids equal)."""
    out = []
    jl = np.asarray(je.prefill(PROMPTS), np.float32)
    pl = pe.prefill(PROMPTS).numpy()
    for step in range(STEPS + 1):
        tol = REL_TOL * np.abs(jl[ACTIVE]).max()
        top2 = np.sort(jl[ACTIVE], axis=-1)[:, -2:]
        jid, pid = jl.argmax(-1), pl.argmax(-1)
        out.append((np.abs(pl - jl)[ACTIVE].max() / tol,
                    (top2[:, 1] - top2[:, 0]).min() / tol,
                    bool(np.array_equal(pid[ACTIVE], jid[ACTIVE]))))
        if step < STEPS:
            jl = np.asarray(je.decode(jnp.asarray(jid, jnp.int32),
                                      jnp.asarray(ACTIVE)), np.float32)
            pl = pe.decode(torch.from_numpy(pid.astype(np.int32)),
                           torch.from_numpy(ACTIVE)).numpy()
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_formats_match_jax(name, monkeypatch):
    je, pe = engines(name, CONFIGS[name][3], monkeypatch)
    _build.reset_counts()
    steps = greedy_run(je, pe)
    for step, (diff, margin, same) in enumerate(steps):
        assert diff <= 1.0, (step, diff)
        assert margin > 1.0, (step, margin)
        assert same, step
    # the routes: int8 compute at prefill (96 rows) only, weight-only else
    n_int8 = _build.plain_dispatches["qmatmul_int8"]
    n_w = _build.plain_dispatches["qmatmul"]
    per_layer = 4                        # qkv, o, gate/up, down (fused)
    if CONFIGS[name][2]:
        # the head is a 3-row GEMV at prefill; decode steps have 3 rows
        assert n_int8 == per_layer * CFG["n_layers"]
        assert n_w == 1 + STEPS * (per_layer * CFG["n_layers"] + 1)
    else:
        assert n_int8 == 0 and n_w > 0


def test_mixed_policy_packs_and_fuses():
    """The policy's decisions survive the carry and `fuse_params`: fused
    int4 QKV and gate/up, an nf4 `o`, an int8 `ffn.down` (no K-repad), a
    dense head."""
    jp = jax_params("mixed-policy", 0)
    pe = Engine(params_from_numpy(tree_to_numpy(jp), device="cpu"),
                ArchConfig(**CFG), max_batch=1, max_len=64, device="cpu",
                comp=None)
    lp = pe.params["layers"][0]
    assert lp["qkv"]["w"].spec.bits == 4 and lp["qkv"]["w"].shape == (1024, 512)
    assert lp["o"]["w"].spec.is_lut and lp["o"]["w"].shape == (1024, 256)
    assert lp["ffn"]["gateup"]["w"].shape == (1024, 1024)
    down = lp["ffn"]["down"]["w"]
    assert down.spec.bits == 8 and down.shape == (512, 256)
    assert down.data[0].dtype == torch.uint8
    assert not isinstance(pe.params["lm_head"]["w"], QTensor)


@pytest.mark.parametrize("name", ["int5-asym", "fp8_e4m3"])
def test_fuse_params_keeps_zero_points_and_fp8_rows(name):
    jp = jax_params(name, 1)
    pe = Engine(params_from_numpy(tree_to_numpy(jp), device="cpu"),
                ArchConfig(**CFG), max_batch=1, max_len=64, device="cpu",
                comp=None)
    qkv = pe.params["layers"][0]["qkv"]["w"]
    k = 4096 if name == "int5-asym" else 256
    assert qkv.shape == (k, 512)
    if name == "int5-asym":
        assert qkv.zeros.shape == (k // 128, 512)
        assert qkv.zeros.dtype == torch.uint8 and len(qkv.data) == 2
        assert not qkv.zeros[2:].any()    # padded groups: zero scales, zp 0
        assert not qkv.scales[2:].any()
    else:
        assert qkv.zeros is None and qkv.data[0].dtype == torch.uint8
