"""A tiny Mixtral (2 layers, 8 query heads over 2 KV heads as Mixtral's
n_rep = 4, 4 experts, top-2) through `Engine` and `PagedEngine` in both
packages: the port on the CPU with its plain versions, JAX on the CPU
(`NST_FLASH=interpret`).  The JAX package's synthetic int4 params (bf16
scales, `experts_stacked` gate/up/down, a float32 router) are carried
across with `params_from_numpy`.

* B = 1: one prompt, then greedy decode, where every MoE layer takes the
  single-token path (`_moe_single` against JAX's `lax.switch`);
* B = 4 ragged: four prompts, then greedy decode with slot 1 a spectator,
  where every step has B*T = 4 rows and takes the grouped path;
* the same requests through `PagedEngine` (page size 16, a pool smaller
  than max_batch x max_len), and the port's paged logits equal to its
  contiguous ones bit for bit;
* the MoE pre / post norms with grok's router rule, teacher-forced.

Held: logits within LOGIT_TOL = 0.2 (as `test_torch_model.py`: bf16
activations summed in another order, exact float32 weights at M <= 32 in
the port against bf16 ones in the JAX CPU path); greedy ids identical with
the top-2 margin above LOGIT_TOL at every step; and every routing decision
of a real token (the gap between the router's top_k-th and next logit, in
the port) above ROUTER_TOL = 4 bf16 ulps of the row's largest |logit|, so
that no token can change experts between the packages.  The params seed
(SEED) is one whose greedy and router margins stay clear (searched on the
CPU).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.models.arch import ArchConfig as JArchConfig
from neural_speed_tpu.models.arch import MoEConfig as JMoEConfig
from neural_speed_tpu.ops.qtypes import QSpec as JSpec, QType as JQType
from neural_speed_tpu.runtime.engine import Engine as JEngine
from neural_speed_tpu.runtime.engine import PagedEngine as JPagedEngine
from neural_speed_tpu.utils.synthetic import synth_params as jax_synth_params
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch.models import transformer as ttr
from neural_speed_tpu_torch.models.arch import ArchConfig, MoEConfig
from neural_speed_tpu_torch.models.params import params_from_numpy
from neural_speed_tpu_torch.runtime.engine import Engine, PagedEngine

from tests.torch_port_util import tree_to_numpy

torch.set_num_threads(1)

LOGIT_TOL = 0.2
ROUTER_ULPS = 2
CFG = dict(name="mixtral", vocab_size=128, hidden_size=256, n_layers=2,
           n_heads=8, n_kv_heads=2, intermediate_size=512,
           max_position_embeddings=256)
MOE = (4, 2)
MAX_LEN = 128
PROMPTS = [list(np.random.default_rng(1).integers(1, 128, 13)),
           [7, 7, 100, 3], list(np.random.default_rng(2).integers(1, 128, 9)),
           [11, 12, 13, 14, 15, 16]]
ACTIVE = np.array([True, False, True, True])
STEPS = 4
SEED = 33


def _cfgs():
    return (JArchConfig(**CFG, moe=JMoEConfig(*MOE), kv_append="fused"),
            ArchConfig(**CFG, moe=MoEConfig(*MOE), kv_append="fused"))


def engines(seed, batch, paged, monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")
    jcfg, tcfg = _cfgs()
    jp = jax_synth_params(
        jcfg, JSpec(JQType.INT, 4, 64, True, scale_dtype="bfloat16"),
        seed=seed)
    tp = params_from_numpy(tree_to_numpy(jp), device="cpu")
    kw = dict(page_size=16, n_pages=batch * MAX_LEN // 16 - 4) if paged else {}
    je = (JPagedEngine if paged else JEngine)(
        jp, jcfg, max_batch=batch, max_len=MAX_LEN, kv_quantized=True, **kw)
    pe = (PagedEngine if paged else Engine)(
        tp, tcfg, max_batch=batch, max_len=MAX_LEN, kv_quantized=True,
        device="cpu", **kw)
    return je, pe


class RouterMargins:
    """Wraps the port's `moe_ffn` to record, per call, the gap between the
    router's top_k-th and (top_k + 1)-th logit over its largest |logit|,
    for the rows the caller marks as real tokens."""

    def __init__(self, monkeypatch):
        self.rows = None
        self.worst = np.inf
        inner = ttr.moe_ffn

        def wrapped(x, p, cfg, *a, **kw):
            logits = ttr.linear(x, p["router"]).float()
            vals = torch.sort(logits, dim=-1, descending=True).values
            k = cfg.moe.top_k
            gap = (vals[..., k - 1] - vals[..., k]) / (
                logits.abs().amax(-1) * ROUTER_ULPS * 2.0 ** -8)
            self.worst = min(self.worst, gap[self.rows(x.shape)].min().item())
            return inner(x, p, cfg, *a, **kw)

        monkeypatch.setattr(ttr, "moe_ffn", wrapped)


def run(je, pe, margins, prompts, active):
    """Prefill `prompts`, then greedy steps with `active` slots; asserts
    logits within LOGIT_TOL and equal ids with clear margins at each
    step.  Returns the port's logits of every step and the smallest
    top-2 margin."""
    lens = [len(p) for p in prompts]

    def prefill_rows(shape):
        return torch.arange(shape[1])[None] < torch.tensor(lens)[:, None]

    margins.rows = prefill_rows
    jl = np.asarray(je.prefill(prompts), np.float32)
    pl = pe.prefill(prompts)
    margins.rows = lambda shape: torch.from_numpy(active)[:, None]
    out, least = [pl], np.inf
    for step in range(STEPS):
        a = np.ones_like(active) if step == 0 else active
        np.testing.assert_allclose(pl.numpy()[a], jl[a], rtol=0,
                                   atol=LOGIT_TOL, err_msg=f"step {step}")
        top2 = np.sort(jl[a], axis=-1)[:, -2:]
        least = min(least, (top2[:, 1] - top2[:, 0]).min())
        jid, pid = jl.argmax(-1), pl.numpy().argmax(-1)
        np.testing.assert_array_equal(pid[a], jid[a], err_msg=f"step {step}")
        jl = np.asarray(je.decode(jnp.asarray(jid, jnp.int32),
                                  jnp.asarray(active)), np.float32)
        pl = pe.decode(torch.from_numpy(pid.astype(np.int32)),
                       torch.from_numpy(active))
        out.append(pl)
    return out, least


CASES = {"B=1": ([PROMPTS[0]], np.array([True])),
         "B=4 ragged": (PROMPTS, ACTIVE)}


@pytest.mark.parametrize("paged", [False, True], ids=["Engine", "PagedEngine"])
@pytest.mark.parametrize("case", list(CASES))
def test_tiny_mixtral_matches_jax(case, paged, monkeypatch):
    prompts, active = CASES[case]
    je, pe = engines(SEED, len(active), paged, monkeypatch)
    margins = RouterMargins(monkeypatch)
    before = _build.plain_dispatches["qmatmul_grouped"]
    _, least = run(je, pe, margins, prompts, active)
    assert least > LOGIT_TOL
    assert margins.worst > 1.0
    assert _build.plain_dispatches["qmatmul_grouped"] > before


def test_moe_norms_and_global_router_match_jax(monkeypatch):
    """The MoE layer's pre / post norms and grok's router rule (the global
    softmax's probabilities, not renormalized) through both packages'
    `Engine`: prefill and two decode steps of the ragged requests, logits
    within LOGIT_TOL."""
    monkeypatch.setenv("NST_FLASH", "interpret")
    moe = dict(num_experts=MOE[0], top_k=MOE[1], pre_norm=True,
               post_norm=True, renorm=False)
    jcfg = JArchConfig(**CFG, moe=JMoEConfig(**moe), kv_append="fused")
    tcfg = ArchConfig(**CFG, moe=MoEConfig(**moe), kv_append="fused")
    jp = jax_synth_params(
        jcfg, JSpec(JQType.INT, 4, 64, True, scale_dtype="bfloat16"),
        seed=SEED)
    assert "pre_norm" in jp["layers"][0]["moe"]
    je = JEngine(jp, jcfg, max_batch=4, max_len=MAX_LEN, kv_quantized=True)
    pe = Engine(params_from_numpy(tree_to_numpy(jp), device="cpu"), tcfg,
                max_batch=4, max_len=MAX_LEN, kv_quantized=True, device="cpu")
    jl = np.asarray(je.prefill(PROMPTS), np.float32)
    pl = pe.prefill(PROMPTS).numpy()
    for step in range(3):
        np.testing.assert_allclose(pl[ACTIVE], jl[ACTIVE], rtol=0,
                                   atol=LOGIT_TOL, err_msg=f"step {step}")
        ids = jl.argmax(-1).astype(np.int32)
        jl = np.asarray(je.decode(jnp.asarray(ids), jnp.asarray(ACTIVE)),
                        np.float32)
        pl = pe.decode(torch.from_numpy(ids), torch.from_numpy(ACTIVE)).numpy()


def test_paged_logits_equal_contiguous(monkeypatch):
    """The port's `PagedEngine` gives its contiguous `Engine`'s logits bit
    for bit on the ragged requests."""
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    jp = jax_synth_params(
        jcfg, JSpec(JQType.INT, 4, 64, True, scale_dtype="bfloat16"),
        seed=SEED)
    tp = params_from_numpy(tree_to_numpy(jp), device="cpu")
    engs = [Engine(tp, tcfg, max_batch=4, max_len=MAX_LEN, kv_quantized=True,
                   device="cpu"),
            PagedEngine(tp, tcfg, max_batch=4, max_len=MAX_LEN,
                        kv_quantized=True, device="cpu", page_size=16,
                        n_pages=28)]
    logits = [e.prefill(PROMPTS) for e in engs]
    assert torch.equal(logits[0], logits[1])
    for _ in range(3):
        tok = logits[0].argmax(-1).to(torch.int32)
        logits = [e.decode(tok, torch.from_numpy(ACTIVE)) for e in engs]
        assert torch.equal(logits[0], logits[1])
