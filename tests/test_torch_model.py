"""A tiny llama through `Engine` in both packages (the port on the CPU, with
its plain versions; JAX on the CPU).

The JAX package's synthetic int4 params (bf16 group scales) are carried
across with `params_from_numpy`, and both engines fuse them (QKV, gate/up,
the FFN-down K-repad 448 -> 512).  A ragged batch of 3 prompts, with slot 1
a spectator during decode.  Parametrised over the decode KV-append path:
`plain` (JAX with NST_FLASH=off: append first, f32 XLA attention) and
`fused` (JAX with NST_FLASH=interpret: the Pallas decode kernel with the
in-kernel append).

Checked:
* the bytes of layer 0 of the cache.  Both packages quantize with the same
  rule (bit-identical on identical inputs: test_torch_kv_cache.py), but the
  k/v projections that feed it are bf16 values whose f32 sums are taken in
  another order, and at decode (M <= 32) the port computes in f32 on exact
  weights where the JAX CPU path (`qmatmul_xla`) rounds them to bf16.  So a
  rare code moves by 1 and a rare scale by one bf16 ulp: after prefill at
  most 0.01% of the codes and scales differ, after decode at most 1%;
* logits within LOGIT_TOL = 0.2, about 6 bf16 ulps at |logit| ~ 8: the bf16
  rounding of activations and of the LM head's output (one ulp is 0.03
  there), the M <= 32 weight rounding above and, in `plain` mode, JAX's f32
  attention against the port's bf16 rounding of q and P (measured at most
  0.17 with these params);
* greedy ids for 8 steps identical, with the top-1/top-2 margin above
  LOGIT_TOL at every step so that the equality is not a coin toss.  The
  logits are bf16 values, so exact ties are common on a random model; the
  params' seed (71) is one whose greedy streams keep a clear margin.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.models.arch import ArchConfig as JArchConfig
from neural_speed_tpu.ops.qtypes import QSpec as JSpec, QType as JQType
from neural_speed_tpu.runtime.engine import Engine as JEngine
from neural_speed_tpu.utils.synthetic import synth_params as jax_synth_params
from neural_speed_tpu_torch.models.arch import ArchConfig
from neural_speed_tpu_torch.models.params import params_from_numpy
from neural_speed_tpu_torch.runtime.engine import Engine

from tests.torch_port_util import (bf16_to_f32, to_numpy, torch_to_numpy,
                                   tree_to_numpy)

torch.set_num_threads(1)

LOGIT_TOL = 0.2
CFG = dict(name="llama", vocab_size=256, hidden_size=256, n_layers=2,
           n_heads=8, n_kv_heads=4, intermediate_size=448,
           max_position_embeddings=256)
PROMPTS = [[5, 9, 2, 44, 17, 3, 8, 1, 200],
           [7, 7, 100, 3],
           [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23]]
ACTIVE = np.array([True, False, True])


def _engines(mode, monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret" if mode == "fused" else "off")
    jcfg = JArchConfig(**CFG, kv_append=mode)
    jp = jax_synth_params(
        jcfg, JSpec(JQType.INT, 4, 64, True, scale_dtype="bfloat16"), seed=71)
    je = JEngine(jp, jcfg, max_batch=3, max_len=128, kv_quantized=True)
    pe = Engine(params_from_numpy(tree_to_numpy(jp), device="cpu"),
                ArchConfig(**CFG, kv_append=mode), max_batch=3, max_len=128,
                kv_quantized=True, device="cpu")
    assert pe.params["layers"][0]["ffn"]["down"]["w"].shape == (512, 256)
    return je, pe


def _layer0(cache, name, port):
    a = getattr(cache, name)
    return (torch_to_numpy(a) if port else to_numpy(a))[0]


def _check_layer0(port_cache, jax_cache, max_share):
    for name in ("k", "v"):
        got = _layer0(port_cache, name, True).astype(np.int32)
        want = _layer0(jax_cache, name, False).astype(np.int32)
        assert np.abs(got - want).max() <= 1, name
        assert (got != want).mean() <= max_share, name
    for name in ("k_scale", "v_scale"):
        got = bf16_to_f32(_layer0(port_cache, name, True))
        want = bf16_to_f32(_layer0(jax_cache, name, False))
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
        assert (got != want).mean() <= max_share, name


@pytest.mark.parametrize("mode", ["plain", "fused"])
def test_engine_matches_jax(mode, monkeypatch):
    je, pe = _engines(mode, monkeypatch)

    # prefill: logits and the layer-0 cache
    jl = np.asarray(je.prefill(PROMPTS), np.float32)
    pl = pe.prefill(PROMPTS).numpy()
    np.testing.assert_allclose(pl, jl, rtol=0, atol=LOGIT_TOL)
    _check_layer0(pe.cache, je.cache, 1e-4)

    # teacher-forced decode with slot 1 a spectator
    for toks in ([3, 4, 5], [9, 9, 9], [1, 2, 3], [77, 78, 79]):
        jl = np.asarray(je.decode(jnp.asarray(toks, jnp.int32),
                                  jnp.asarray(ACTIVE)), np.float32)
        pl = pe.decode(torch.tensor(toks, dtype=torch.int32),
                       torch.from_numpy(ACTIVE)).numpy()
        np.testing.assert_allclose(pl[ACTIVE], jl[ACTIVE], rtol=0,
                                   atol=LOGIT_TOL)
    np.testing.assert_array_equal(torch_to_numpy(pe.cache.lengths),
                                  np.asarray(je.cache.lengths))
    _check_layer0(pe.cache, je.cache, 1e-2)
    # the spectator's rows past its 32-row prefill window stay untouched
    assert np.all(_layer0(pe.cache, "k", True)[1, :, 32:] == 0)

    # greedy: each engine follows its own argmax
    jl = np.asarray(je.prefill(PROMPTS), np.float32)
    pl = pe.prefill(PROMPTS).numpy()
    for step in range(8):
        top2 = np.sort(jl[ACTIVE], axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > LOGIT_TOL), step
        jid, pid = jl.argmax(-1), pl.argmax(-1)
        np.testing.assert_array_equal(pid[ACTIVE], jid[ACTIVE])
        jl = np.asarray(je.decode(jnp.asarray(jid, jnp.int32),
                                  jnp.asarray(ACTIVE)), np.float32)
        pl = pe.decode(torch.from_numpy(pid.astype(np.int32)),
                       torch.from_numpy(ACTIVE)).numpy()


def test_generate_greedy_runs_on_the_cpu(monkeypatch):
    _, pe = _engines("fused", monkeypatch)
    ids = pe.generate_greedy(PROMPTS[0], 5)
    assert len(ids) == 5 and all(0 <= i < CFG["vocab_size"] for i in ids)
