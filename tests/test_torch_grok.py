"""Grok-1 through the port against the JAX package on the CPU.

A tiny grok from each package's `grok_arch`: 2 layers, hidden 256, 12
query heads over 2 KV heads (Grok-1's n_rep 6) of head dim 128 (q_dim
1536), 4 experts of width 512 top-2 with the router's global softmax,
GELU experts, the sandwich norms (after attention; after the MoE), the
embedding multiplier and the output multiplier, the head tied to the
embedding.  The JAX package's synthetic int4 params are carried across
with `params_from_numpy`; JAX runs its Pallas attention in interpret mode.

* Both packages' `Engine` and `PagedEngine` at B = 1 and B = 4 ragged
  (slot 1 a spectator in decode), over the default bf16 cache and over
  int8 K/V with float32 scales (`kv_scale_dtype`): logits within
  LOGIT_TOL, greedy ids identical with the top-2 margin above LOGIT_TOL at
  every step, and every routing decision of a real token clear of a tie
  (`RouterMargins`); the params seed per configuration (SEEDS) was
  searched on the CPU for both.
* Grok's softcap of 30 does not bite at these weights (|score| stays far
  below 30), so one case sets it to SOFTCAP_BITES, where it moves the
  logits by more than twice LOGIT_TOL (so a version without it would fail
  the agreement), and holds both packages there too.
* The post-FFN sandwich norm (`post_ffn_norm`, no served model sets it)
  on the sequential and the parallel-residual returns.
* `map_grok` on a drawn tiny checkpoint in the hpcai-tech key scheme (the
  names of `hf_shapes("grok-1")`): the port's params equal the JAX
  mapper's bit for bit, dense and int4, and `hf_shapes` names every key
  the JAX mapper reads.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.convert import hf as JH
from neural_speed_tpu.models.arch import ArchConfig as JArchConfig
from neural_speed_tpu.models.configs import grok_arch as j_grok_arch
from neural_speed_tpu.ops.qtypes import QSpec as JSpec, QType as JQType
from neural_speed_tpu.runtime.engine import Engine as JEngine
from neural_speed_tpu.runtime.engine import PagedEngine as JPagedEngine
from neural_speed_tpu.utils.synthetic import synth_params as jax_synth_params
from neural_speed_tpu_torch.convert import hf as TH
from neural_speed_tpu_torch.models.arch import ArchConfig
from neural_speed_tpu_torch.models.configs import (arch_from_hf_config,
                                                   grok_arch)
from neural_speed_tpu_torch.models.params import params_from_numpy
from neural_speed_tpu_torch.ops.qtypes import QSpec, QType
from neural_speed_tpu_torch.runtime.engine import Engine, PagedEngine
from neural_speed_tpu_torch.utils.synthetic import (hf_shapes,
                                                    synth_hf_state_dict)

from tests.test_torch_moe_model import RouterMargins
from tests.torch_port_util import assert_tree_equal, tree_to_numpy

torch.set_num_threads(1)

# logits within 0.2, as the tiny Mixtral's (`test_torch_moe_model.py`):
# bf16 activations summed in another order, exact float32 weights at
# M <= 32 in the port against bf16 ones in the JAX CPU path
LOGIT_TOL = 0.2
GROK_HF = {"model_type": "grok-1", "vocab_size": 256, "hidden_size": 256,
           "intermediate_size": 512, "num_hidden_layers": 2,
           "num_attention_heads": 12, "num_key_value_heads": 2,
           "max_position_embeddings": 256, "rms_norm_eps": 1e-5,
           "num_local_experts": 4, "num_experts_per_tok": 2,
           "embedding_multiplier_scale": 78.38367176906169,
           "output_multiplier_scale": 0.5773502691896257}
HEAD_DIM = 128
MAX_LEN = 128
PROMPTS = [list(np.random.default_rng(1).integers(1, 256, 13)),
           [7, 7, 100, 3], list(np.random.default_rng(2).integers(1, 256, 9)),
           [11, 12, 13, 14, 15, 16]]
ACTIVE = np.array([True, False, True, True])
STEPS = 4
SOFTCAP_BITES = 0.1
# KV layouts: (JAX engine arguments, port engine arguments)
KV = {"bf16": ({}, {}),
      "int8 f32 scales": (dict(kv_quantized=True,
                               kv_scale_dtype=jnp.float32),
                          dict(kv_quantized=True,
                               kv_scale_dtype=torch.float32))}
CASES = {"B=1": ([PROMPTS[0]], np.array([True])),
         "B=4 ragged": (PROMPTS, ACTIVE)}
# params seed per (KV layout, softcap): greedy top-2 margins above 1.5 x
# LOGIT_TOL and router gaps above 1.5 x ROUTER_TOL at B = 1 and B = 4
# (searched on the CPU over seeds 0-29); at SOFTCAP_BITES (seeds 0-39 at
# caps 0.5, 0.25 and 0.1) the one seed whose margins stay clear and whose
# prefill logits move more than 2 x LOGIT_TOL (0.82) under the softcap:
# the attention output reaches the logits through the post-attention norm,
# beside a residual that the 78x embedding multiplier dominates.
SEEDS = {("bf16", 30.0): 15, ("int8 f32 scales", 30.0): 15,
         ("bf16", SOFTCAP_BITES): 12}


def _cfgs(softcap=30.0, **kw):
    """The tiny grok of both packages, equal field for field."""
    base = dict(head_dim=HEAD_DIM, logit_softcap=softcap, kv_append="fused",
                **kw)
    jcfg = dataclasses.replace(j_grok_arch(GROK_HF), **base)
    tcfg = dataclasses.replace(arch_from_hf_config(GROK_HF), **base)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _params(jcfg, seed):
    jp = jax_synth_params(
        jcfg, JSpec(JQType.INT, 4, 64, True, scale_dtype="bfloat16"),
        seed=seed)
    return jp, params_from_numpy(tree_to_numpy(jp), device="cpu")


def _engines(jcfg, tcfg, seed, batch, paged, kv):
    jp, tp = _params(jcfg, seed)
    jkw, tkw = KV[kv]
    if paged:
        pg = dict(page_size=16, n_pages=batch * MAX_LEN // 16 - 4)
        jkw, tkw = dict(jkw, **pg), dict(tkw, **pg)
    je = (JPagedEngine if paged else JEngine)(
        jp, jcfg, max_batch=batch, max_len=MAX_LEN, **jkw)
    pe = (PagedEngine if paged else Engine)(
        tp, tcfg, max_batch=batch, max_len=MAX_LEN, device="cpu", **tkw)
    return je, pe


def run(je, pe, margins, prompts, active, steps=STEPS):
    """Prefill, then greedy steps with `active` slots: logits within
    LOGIT_TOL and equal ids at each step.  Returns the port's logits of
    every step and the smallest top-2 margin of the JAX logits."""
    lens = torch.tensor([len(p) for p in prompts])
    margins.rows = lambda shape: (
        torch.arange(shape[1])[None] < lens[:, None] if shape[1] > 1
        else torch.from_numpy(active)[:, None])
    jl = np.asarray(je.prefill(prompts), np.float32)
    pl = pe.prefill(prompts)
    out, least = [pl], np.inf
    for step in range(steps):
        a = np.ones_like(active) if step == 0 else active
        np.testing.assert_allclose(pl.numpy()[a], jl[a], rtol=0,
                                   atol=LOGIT_TOL, err_msg=f"step {step}")
        top2 = np.sort(jl[a], axis=-1)[:, -2:]
        least = min(least, (top2[:, 1] - top2[:, 0]).min())
        jid, pid = jl.argmax(-1), pl.numpy().argmax(-1)
        np.testing.assert_array_equal(pid[a], jid[a], err_msg=f"step {step}")
        if step == steps - 1:
            break
        jl = np.asarray(je.decode(jnp.asarray(jid, jnp.int32),
                                  jnp.asarray(active)), np.float32)
        pl = pe.decode(torch.from_numpy(pid.astype(np.int32)),
                       torch.from_numpy(active))
        out.append(pl)
    return out, least


@pytest.mark.parametrize("paged", [False, True], ids=["Engine", "PagedEngine"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kv", list(KV))
def test_tiny_grok_matches_jax(kv, case, paged, monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")
    prompts, active = CASES[case]
    jcfg, tcfg = _cfgs()
    je, pe = _engines(jcfg, tcfg, SEEDS[kv, 30.0], len(active), paged, kv)
    margins = RouterMargins(monkeypatch)
    _, least = run(je, pe, margins, prompts, active)
    assert least > LOGIT_TOL
    assert margins.worst > 1.0
    if kv != "bf16":
        assert pe.cache.k_scale.dtype == torch.float32


@pytest.mark.parametrize("case", list(CASES))
def test_softcap_that_bites_matches_jax(case, monkeypatch):
    """At SOFTCAP_BITES the softcap moves the port's logits by more than
    twice LOGIT_TOL, and both packages still agree."""
    monkeypatch.setenv("NST_FLASH", "interpret")
    prompts, active = CASES[case]
    seed = SEEDS["bf16", SOFTCAP_BITES]
    jcfg, tcfg = _cfgs(SOFTCAP_BITES)
    je, pe = _engines(jcfg, tcfg, seed, len(active), False, "bf16")
    margins = RouterMargins(monkeypatch)
    capped, least = run(je, pe, margins, prompts, active)
    assert least > LOGIT_TOL
    assert margins.worst > 1.0
    _, tcfg_off = _cfgs(0.0)
    _, plain = _engines(jcfg, tcfg_off, seed, len(active), False, "bf16")
    uncapped = plain.prefill(prompts)
    assert (capped[0] - uncapped).abs().max() > 2 * LOGIT_TOL


@pytest.mark.parametrize("parallel", [False, True],
                         ids=["sequential", "parallel residual"])
def test_post_ffn_norm_matches_jax(parallel, monkeypatch):
    """`post_ffn_norm` on a tiny llama, sequential and with the parallel
    residual (two norms): prefill and two teacher-forced decode steps of
    the ragged requests, logits within LOGIT_TOL."""
    monkeypatch.setenv("NST_FLASH", "interpret")
    kw = dict(name="llama", vocab_size=256, hidden_size=256, n_layers=2,
              n_heads=4, n_kv_heads=2, intermediate_size=512,
              max_position_embeddings=256, post_ffn_norm=True,
              parallel_residual=parallel, kv_append="fused")
    jcfg, tcfg = JArchConfig(**kw), ArchConfig(**kw)
    jp, tp = _params(jcfg, 3)
    assert "post_ffn_norm" in jp["layers"][0]
    je = JEngine(jp, jcfg, max_batch=4, max_len=MAX_LEN)
    pe = Engine(tp, tcfg, max_batch=4, max_len=MAX_LEN, device="cpu")
    jl = np.asarray(je.prefill(PROMPTS), np.float32)
    pl = pe.prefill(PROMPTS).numpy()
    for step in range(3):
        np.testing.assert_allclose(pl[ACTIVE], jl[ACTIVE], rtol=0,
                                   atol=LOGIT_TOL, err_msg=f"step {step}")
        ids = jl.argmax(-1).astype(np.int32)
        jl = np.asarray(je.decode(jnp.asarray(ids), jnp.asarray(ACTIVE)),
                        np.float32)
        pl = pe.decode(torch.from_numpy(ids), torch.from_numpy(ACTIVE)).numpy()


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int4-g64"])
def test_map_grok_matches_jax(quant):
    """A drawn tiny grok checkpoint in the hpcai-tech layout through both
    packages' `params_from_state_dict`."""
    tcfg = arch_from_hf_config(GROK_HF)
    jcfg = j_grok_arch(GROK_HF)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    sd = synth_hf_state_dict("grok-1", tcfg, seed=4, dtype=torch.float32,
                             device="cpu")
    assert sd["transformer.decoder_layer.1.moe.3.linear_v.weight"].shape == (
        512, 256)
    jspec, tspec = ((JSpec(JQType.INT, 4, 64, True, scale_dtype="bfloat16"),
                     QSpec(QType.INT, 4, 64, True, scale_dtype="bfloat16"))
                    if quant else (None, None))
    jp = JH.params_from_state_dict(sd, jcfg, jspec)
    tp = TH.params_from_state_dict(sd, tcfg, tspec, device="cpu")
    assert_tree_equal(jp, tp)
    assert "lm_head" not in tp and len(tp["layers"][0]["moe"]["experts"]) == 4


def test_hf_shapes_hold_every_key_the_jax_mapper_reads():
    """The JAX mapper reads exactly `hf_shapes("grok-1")`'s keys (the
    checkpoint has no head: it is tied)."""
    cfg = grok_arch(GROK_HF)
    shapes = hf_shapes("grok-1", cfg)
    assert hf_shapes("grok", cfg) == shapes

    class Reads(dict):
        read = set()

        def __getitem__(self, key):
            Reads.read.add(key)
            return super().__getitem__(key)

    sd = Reads({k: np.zeros(s, np.float32) for k, s in shapes.items()})
    JH.map_grok(sd, j_grok_arch(GROK_HF), JH.Converter(
        j_grok_arch(GROK_HF), None))
    assert Reads.read == set(shapes)
