"""The MoE layers' activation: the tiny Mixtral of `test_torch_moe_model.py`
with grok's GELU (`act="gelu_tanh"`) through both packages' `Engine`.

The JAX package applies `_ACTS[cfg.act]` on both of its MoE paths (the
grouped GEMMs, `_moe_grouped`, and the single-token `lax.switch` through
`ffn`); so must the port's `_moe_grouped` (B*T > 1) and `_moe_single`
(B*T == 1).  Held:

* both packages at B = 1 (every MoE call takes the single-token path) and
  B = 4 ragged (the grouped path), prefill and three teacher-forced decode
  steps, logits within LOGIT_TOL (as `test_torch_moe_model.py`), with
  every routing decision of a real token clear of a tie (RouterMargins).
  With SiLU on both of the port's paths this fails the B = 4 case (2.4
  against LOGIT_TOL; near 0 the two activations agree to first order, so
  the B = 1 case does not see it);
* the port's stacked experts (`experts_stacked`: kernel 11's plain
  version) against its own unstacked experts (a list of per-expert FFNs
  through `ffn`), the same params, within LOGIT_TOL.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.models.arch import ArchConfig as JArchConfig
from neural_speed_tpu.models.arch import MoEConfig as JMoEConfig
from neural_speed_tpu.ops.qtypes import QSpec as JSpec, QType as JQType
from neural_speed_tpu.runtime.engine import Engine as JEngine
from neural_speed_tpu.utils.synthetic import synth_params as jax_synth_params
from neural_speed_tpu_torch.models import transformer as ttr
from neural_speed_tpu_torch.models.arch import ArchConfig, MoEConfig
from neural_speed_tpu_torch.models.params import params_from_numpy
from neural_speed_tpu_torch.runtime.engine import Engine

from tests.test_torch_moe_model import (ACTIVE, CFG, LOGIT_TOL, MAX_LEN, MOE,
                                        PROMPTS, RouterMargins)
from tests.torch_port_util import tree_to_numpy

torch.set_num_threads(1)

ACT = "gelu_tanh"
STEPS = 3
# A params seed whose routing decisions stay clear of ties under GELU at
# B = 1 and B = 4 (the smallest router gap 4.2x ROUTER_TOL; largest logit
# difference 0.062), searched on the CPU over seeds 0-39: the Mixtral
# test's seed 33 keeps them clear under SiLU only.
SEED = 18
CASES = {"B=1": ([PROMPTS[0]], np.array([True])),
         "B=4 ragged": (PROMPTS, ACTIVE)}


def _params():
    jcfg = JArchConfig(**CFG, act=ACT, moe=JMoEConfig(*MOE),
                       kv_append="fused")
    tcfg = ArchConfig(**CFG, act=ACT, moe=MoEConfig(*MOE), kv_append="fused")
    jp = jax_synth_params(
        jcfg, JSpec(JQType.INT, 4, 64, True, scale_dtype="bfloat16"),
        seed=SEED)
    return jcfg, tcfg, jp


def _teacher_forced(engines, prompts, active, check):
    """Prefill, then STEPS decode steps fed the first engine's greedy ids;
    `check(logits_a, logits_b, rows, step)` at every step."""
    b = len(active)
    logits = [np.asarray(e.prefill(prompts), np.float32) for e in engines]
    for step in range(STEPS + 1):
        rows = np.ones((b,), bool) if step == 0 else active
        check(logits[0], logits[1], rows, step)
        if step == STEPS:
            break
        ids = logits[0].argmax(-1).astype(np.int32)
        logits = [np.asarray(e.decode(*args), np.float32)
                  for e, args in zip(engines, (
                      (jnp.asarray(ids), jnp.asarray(active)),
                      (torch.from_numpy(ids), torch.from_numpy(active))))]


def _within_tol(a, b, rows, step):
    np.testing.assert_allclose(b[rows], a[rows], rtol=0, atol=LOGIT_TOL,
                               err_msg=f"step {step}")


@pytest.mark.parametrize("case", list(CASES))
def test_moe_activation_matches_jax(case, monkeypatch):
    """GELU experts: the port's single-token (B = 1) and grouped (B = 4)
    paths against the JAX package's."""
    monkeypatch.setenv("NST_FLASH", "interpret")
    prompts, active = CASES[case]
    jcfg, tcfg, jp = _params()
    b = len(active)
    je = JEngine(jp, jcfg, max_batch=b, max_len=MAX_LEN, kv_quantized=True)
    pe = Engine(params_from_numpy(tree_to_numpy(jp), device="cpu"), tcfg,
                max_batch=b, max_len=MAX_LEN, kv_quantized=True,
                device="cpu")
    lens = torch.tensor([len(p) for p in prompts])
    margins = RouterMargins(monkeypatch)
    margins.rows = lambda shape: (
        torch.arange(shape[1])[None] < lens[:, None] if shape[1] > 1
        else torch.from_numpy(active)[:, None])
    _teacher_forced((je, pe), prompts, active, _within_tol)
    assert margins.worst > 1.0


def _unstacked(params):
    """The same params with each layer's expert stacks split into a list
    of per-expert FFNs (the `ffn` route of `moe_ffn`)."""
    layers = []
    for lp in params["layers"]:
        st = lp["moe"]["experts_stacked"]
        n = next(iter(st.values())).n_experts
        moe = {k: v for k, v in lp["moe"].items() if k != "experts_stacked"}
        moe["experts"] = [ttr._expert_view(st, e) for e in range(n)]
        layers.append(dict(lp, moe=moe))
    return dict(params, layers=layers)


@pytest.mark.parametrize("case", list(CASES))
def test_stacked_and_unstacked_experts_agree(case):
    """The port's two expert routes under GELU: `experts_stacked` (the
    grouped / single-token paths) and the per-expert list through `ffn`,
    which applies `_ACTS[cfg.act]`, the same params."""
    prompts, active = CASES[case]
    _, tcfg, jp = _params()
    tp = params_from_numpy(tree_to_numpy(jp), device="cpu")
    b = len(active)
    engs = [Engine(p, tcfg, max_batch=b, max_len=MAX_LEN, kv_quantized=True,
                   fuse=False, device="cpu") for p in (tp, _unstacked(tp))]
    assert "experts" in engs[1].params["layers"][0]["moe"]
    assert "experts_stacked" in engs[0].params["layers"][0]["moe"]
    engines = [_TorchAsJax(engs[0]), engs[1]]
    _teacher_forced(engines, prompts, active, _within_tol)


@dataclasses.dataclass
class _TorchAsJax:
    """A port engine called as `_teacher_forced` calls the JAX one."""

    eng: Engine

    def prefill(self, prompts):
        return self.eng.prefill(prompts)

    def decode(self, ids, active):
        return self.eng.decode(torch.from_numpy(np.array(ids)),
                               torch.from_numpy(np.array(active)))
