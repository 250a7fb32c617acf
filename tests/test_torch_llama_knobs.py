"""The llama-path knobs that `check_supported` has long let through, held
against the JAX `Engine`: `qkv_bias`, a `head_dim` other than hidden /
heads, `attn_scale`, a partial `rot_dim` (neox and gptj rope),
`tie_word_embeddings`, `logit_scale`, `final_norm=False`, and rope scaling
(linear, ntk, yarn, longrope).

The tiny llama of `tests/test_torch_model.py` (2 layers, params seed 71,
int4 g64 with bf16 scales, int8 KV, `kv_append="plain"`, JAX with
NST_FLASH=off): a ragged batch of 3 prompts, then 4 teacher-forced decode
steps with slot 1 a spectator; logits of the live rows held at every step.
Tolerances: LOGIT_TOL = 0.2, as `test_torch_model.py` (bf16 rounding of
activations and of the head's output, the port's bf16 rounding of q and P
against JAX's float32 attention), except where a knob scales the logits
or the attention scores:
* attn_scale 0.3 (against 1/sqrt(32) = 0.18) sharpens the softmax and
  with it the effect of the bf16 rounding of P: 0.4;
* longrope's per-dim factors stretch the low frequencies the same way:
  0.5;
* final_norm=False leaves the logits at |logit| 130-260, where one bf16
  ulp of the head's output is 1.0 or 2.0 (measured: 1.0 at every step):
  2^-7 of the step's largest |logit|, at least one ulp there.
(Measured largest differences: attn_scale 0.33, longrope 0.45, yarn 0.17,
qkv_bias 0.06.)
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.models.arch import ArchConfig as JArchConfig
from neural_speed_tpu.ops.qtypes import QSpec as JSpec, QType as JQType
from neural_speed_tpu.ops.rope import RopeScaling as JRope
from neural_speed_tpu.runtime.engine import Engine as JEngine
from neural_speed_tpu.utils.synthetic import synth_params as jax_synth_params
from neural_speed_tpu_torch.models.arch import ArchConfig
from neural_speed_tpu_torch.models.params import params_from_numpy
from neural_speed_tpu_torch.ops.rope import RopeScaling
from neural_speed_tpu_torch.runtime.engine import Engine

from tests.torch_port_util import tree_to_numpy

torch.set_num_threads(1)

LOGIT_TOL = 0.2
CFG = dict(name="llama", vocab_size=256, hidden_size=256, n_layers=2,
           n_heads=8, n_kv_heads=4, intermediate_size=448,
           max_position_embeddings=256)
PROMPTS = [[5, 9, 2, 44, 17, 3, 8, 1, 200],
           [7, 7, 100, 3],
           [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23]]
ACTIVE = np.array([True, False, True])
_LONG = tuple(1.0 + 0.25 * i for i in range(8))
_SHORT = tuple(1.0 + 0.05 * i for i in range(8))


def _rope(kind, **kw):
    return lambda cls: cls(kind, **kw)


# name: (ArchConfig fields, tolerance); a callable field value is given the
# package's RopeScaling class; tolerance "ulp" is 2^-7 of the step's largest
# |logit|
KNOBS = {
    "qkv_bias": (dict(qkv_bias=True), LOGIT_TOL),
    "head_dim": (dict(head_dim=48), LOGIT_TOL),
    "attn_scale": (dict(attn_scale=0.3), 0.4),
    "rot_dim neox": (dict(rot_dim=16), LOGIT_TOL),
    "rot_dim gptj": (dict(rope_style="gptj", rot_dim=16), LOGIT_TOL),
    "tie_word_embeddings": (dict(tie_word_embeddings=True), LOGIT_TOL),
    "logit_scale": (dict(logit_scale=0.5), LOGIT_TOL),
    "final_norm": (dict(final_norm=False), "ulp"),
    "rope linear": (dict(rope_scaling=_rope("linear", factor=2.0)),
                    LOGIT_TOL),
    "rope ntk": (dict(rope_scaling=_rope("ntk", factor=2.0)), LOGIT_TOL),
    "rope yarn": (dict(rope_scaling=_rope(
        "yarn", factor=4.0, original_max_position=64)), LOGIT_TOL),
    "rope longrope": (dict(rope_scaling=_rope(
        "longrope", factor=2.0, original_max_position=64,
        long_factors=_LONG, short_factors=_SHORT), rot_dim=16), 0.5),
}


def _fields(knob, rope_cls):
    return {k: (v(rope_cls) if callable(v) else v)
            for k, v in KNOBS[knob][0].items()}


def _engines(knob, monkeypatch):
    monkeypatch.setenv("NST_FLASH", "off")
    jcfg = JArchConfig(**CFG, **_fields(knob, JRope), kv_append="plain")
    tcfg = ArchConfig(**CFG, **_fields(knob, RopeScaling), kv_append="plain")
    jp = jax_synth_params(
        jcfg, JSpec(JQType.INT, 4, 64, True, scale_dtype="bfloat16"), seed=71)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(5)
        for lp in jp["layers"]:
            for n, width in (("q", jcfg.q_dim), ("k", jcfg.kv_dim),
                             ("v", jcfg.kv_dim)):
                lp[n]["b"] = jnp.asarray(
                    rng.standard_normal(width).astype(np.float32) * 0.5)
    je = JEngine(jp, jcfg, max_batch=3, max_len=128, kv_quantized=True)
    pe = Engine(params_from_numpy(tree_to_numpy(jp), device="cpu"), tcfg,
                max_batch=3, max_len=128, kv_quantized=True, device="cpu")
    return je, pe


@pytest.mark.parametrize("knob", list(KNOBS))
def test_knob_matches_jax(knob, monkeypatch):
    je, pe = _engines(knob, monkeypatch)
    tol = KNOBS[knob][1]

    def close(pl, jl, rows, what):
        atol = 2.0 ** -7 * np.abs(jl[rows]).max() if tol == "ulp" else tol
        diff = np.abs(pl[rows] - jl[rows])
        assert np.all(diff <= atol), (knob, what, diff.max())

    jl = np.asarray(je.prefill(PROMPTS), np.float32)
    pl = pe.prefill(PROMPTS).numpy()
    close(pl, jl, np.ones(3, bool), "prefill")
    for step, toks in enumerate(([3, 4, 5], [9, 9, 9], [1, 2, 3],
                                 [77, 78, 79])):
        jl = np.asarray(je.decode(jnp.asarray(toks, jnp.int32),
                                  jnp.asarray(ACTIVE)), np.float32)
        pl = pe.decode(torch.tensor(toks, dtype=torch.int32),
                       torch.from_numpy(ACTIVE)).numpy()
        close(pl, jl, ACTIVE, f"decode {step}")
