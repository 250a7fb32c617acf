"""The HF archs at the head dims of their full-size models, through both
packages' `Engine` and `PagedEngine` on the CPU: gemma at head dim 256
(gemma-7b's), gpt-j at 256 (gpt-j-6b's), phi at 80 (phi-2's) and gpt-neox at
96 (gpt-neox-20b's), each a tiny random-init `transformers` model (2 layers,
vocab 256, 2-4 heads) converted by each package's converter to int4 g32 and
served as `tests/torch_hf_models.py` serves its archs: a prefill and 8
greedy steps of one prompt, the logits within LOGIT_TOL = 0.2 of JAX's, the
JAX top-2 margin above it at every step and the greedy ids identical.  The
cache is the engines' default (bf16, no KV arguments on either side), and
for phi also float32 (`kv_dtype` float32 on both sides), whose plain
versions round K and V to bf16 as the kernels do.  The seeds were searched
on the CPU for streams that keep both the margins and the tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.convert import hf as JH
from neural_speed_tpu.models.configs import arch_from_hf_config as j_arch
from neural_speed_tpu.runtime.engine import Engine as JEngine
from neural_speed_tpu.runtime.engine import PagedEngine as JPagedEngine
from neural_speed_tpu_torch.convert import hf as TH
from neural_speed_tpu_torch.models.configs import arch_from_hf_config
from neural_speed_tpu_torch.runtime.engine import Engine, PagedEngine

from tests.test_torch_hf import _specs, hf_checkpoint
from tests.torch_hf_models import LOGIT_TOL, PROMPTS, STEPS

torch.set_num_threads(1)

# The tiny configs' widths: each arch's full-size head dim.
HEAD_DIM_KW = {
    "gemma": dict(head_dim=256),
    "gptj": dict(n_embd=512, n_head=2, rotary_dim=64),
    "phi": dict(hidden_size=160, num_attention_heads=2,
                num_key_value_heads=2, partial_rotary_factor=0.4),
    "gptneox": dict(hidden_size=192, num_attention_heads=2),
}
# (params seed, initializer_range) per arch and cache: searched on the CPU
# over seeds 0-299 at initializer_range 0.2 for streams whose JAX top-2
# margins stay at 0.23 or more and whose logits stay within 0.17 of JAX's,
# for `Engine` and `PagedEngine` alike (about 1 seed in 15-40 does).
SEEDS = {("gemma", "default"): (27, 0.2), ("gptj", "default"): (114, 0.2),
         ("phi", "default"): (137, 0.2), ("gptneox", "default"): (173, 0.2),
         ("phi", "f32"): (137, 0.2)}


def engines(name: str, kv: str, paged: bool, seed: int, init: float):
    """(JAX engine, port engine) of the tiny `name` model at its head dim,
    over the default cache or (`kv` "f32") a float32 one."""
    hf, sd = hf_checkpoint(name, seed, initializer_range=init,
                           **HEAD_DIM_KW[name])
    jspec, tspec = _specs(32)
    jcfg, tcfg = j_arch(hf), arch_from_hf_config(hf)
    assert tcfg.head_dim == jcfg.head_dim
    jp = JH.params_from_state_dict(sd, jcfg, jspec)
    tp = TH.params_from_state_dict(sd, tcfg, tspec, device="cpu")
    jkw, tkw = dict(max_batch=1, max_len=128), dict(max_batch=1, max_len=128)
    if kv == "f32":
        jkw["kv_dtype"], tkw["kv_dtype"] = jnp.float32, torch.float32
    if paged:
        for kw in (jkw, tkw):
            kw.update(page_size=16, n_pages=8)
        return (JPagedEngine(jp, jcfg, **jkw),
                PagedEngine(tp, tcfg, device="cpu", **tkw))
    return JEngine(jp, jcfg, **jkw), Engine(tp, tcfg, device="cpu", **tkw)


def run_steps(je, pe, name: str, strict: bool = True):
    """A prefill and STEPS greedy steps of PROMPTS[0] through both engines.
    With `strict`, assert at every step; else return the smallest JAX top-2
    margin and the largest logit difference (the seed search's view)."""
    batch = PROMPTS[:1]
    jl = np.asarray(je.prefill(batch), np.float32)
    pl = pe.prefill(batch).numpy()
    active = np.ones(1, bool)
    margin, diff = np.inf, 0.0
    for step in range(STEPS + 1):
        top2 = np.sort(jl, axis=-1)[:, -2:]
        margin = min(margin, float((top2[:, 1] - top2[:, 0]).min()))
        diff = max(diff, float(np.abs(pl - jl).max()))
        jid, pid = jl.argmax(-1), pl.argmax(-1)
        if strict:
            np.testing.assert_allclose(pl, jl, rtol=0, atol=LOGIT_TOL,
                                       err_msg=f"{name} step {step}")
            assert margin > LOGIT_TOL, (name, step, margin)
            np.testing.assert_array_equal(pid, jid, err_msg=f"{name} {step}")
        elif not np.array_equal(pid, jid):
            return margin, np.inf
        if step == STEPS:
            break
        jl = np.asarray(je.decode(jnp.asarray(jid, jnp.int32),
                                  jnp.asarray(active)), np.float32)
        pl = pe.decode(torch.from_numpy(pid.astype(np.int32)),
                       torch.from_numpy(active)).numpy()
    return margin, diff


@pytest.mark.parametrize("paged", [False, True], ids=["Engine", "PagedEngine"])
@pytest.mark.parametrize("name,kv", list(SEEDS), ids=lambda v: str(v))
def test_full_size_head_dims_match_jax(name, kv, paged):
    je, pe = engines(name, kv, paged, *SEEDS[name, kv])
    k = pe.cache.k_pages if paged else pe.cache.k
    assert k.dtype == (torch.float32 if kv == "f32" else torch.bfloat16)
    assert k.shape[-1] == pe.cfg.head_dim == {"gemma": 256, "gptj": 256,
                                              "phi": 80, "gptneox": 96}[name]
    run_steps(je, pe, name)
