"""The HF archs through `Engine` / `PagedEngine` in both packages, on the CPU
(imported by `tests/test_torch_hf_models*.py`, which split the archs so
that no test file takes long alone).

Each arch is a tiny random-init `transformers` model (`tests/test_torch_hf.
hf_checkpoint`: 2 layers, hidden 64, vocab 256), its weights drawn by
`transformers`' own init at `initializer_range` 0.15-0.3 (logits of
magnitude ~6-10, like `tests/test_torch_model.py`'s), converted by each package's own
converter with int4 g32 packs (bf16 scales: kernel A's format), then
served by each package's engine: prefill and 8 greedy steps of two ragged
prompts (MPT, BLOOM, Falcon) or of the first prompt alone (the other
archs, whose logits differ more at decode: the JAX CPU path rounds the
dequantized weights of an M <= 32 product to bf16, the port does not, and
with the RMSNorm / SiLU-gated archs' larger activations that costs up to
~0.2 at |logit| ~10, so fewer streams keep both the margins and the
tolerance).  The JAX side runs its default CPU path (XLA attention; plain
append).  Checked at every step:
* logits within LOGIT_TOL = 0.2, as `tests/test_torch_model.py`: bf16
  rounding of activations and of the LM head's output, and the port's bf16
  rounding of q and P against JAX's float32 attention;
* the JAX top-1/top-2 margin above LOGIT_TOL for both rows, so that equal
  ids are not a coin toss: the seeds (SEEDS) were searched on the CPU for
  streams whose margins stay clear in both cache layouts;
* identical greedy ids.
The cache is the engines' default (bf16, no KV arguments on either side)
or int8 (`kv_quantized=True` on both).  Over int8 both take
`kv_append="plain"` (append, then attend): the port's default fused
decode attends to the current token's unquantized k/v, which the JAX
package does only with its Pallas kernels on (`tests/test_torch_model.py`
holds that path), not on its default CPU path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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

LOGIT_TOL = 0.2
PROMPTS = [[1, 5, 9, 17, 33, 4, 250, 7, 19, 60], [3, 90, 200, 11]]
RAGGED = ("mpt", "bloom", "falcon")    # served with both prompts
STEPS = 8
# (params seed, initializer_range) per arch: a seed whose greedy streams
# keep every top-2 margin of the JAX engine at 0.23 or more and every logit
# within 0.17 of it, in both cache layouts (searched on the CPU over seeds
# 0-599; about 1 in 100-400 does).  The RMSNorm archs draw at 0.15-0.2,
# where their logits stay ~6-8 like the others' at 0.3.
SEEDS = {"mpt": (210, 0.3), "bloom": (218, 0.3), "falcon": (272, 0.3),
         "llama": (18, 0.2), "mistral": (18, 0.2), "mixtral": (152, 0.2),
         "qwen2": (59, 0.2), "phi3": (92, 0.15), "stablelm": (288, 0.2),
         "gemma": (58, 0.3), "baichuan": (60, 0.15), "opt": (41, 0.3),
         "gptj": (15, 0.3), "gptneox": (301, 0.3), "starcoder": (284, 0.3),
         "phi": (324, 0.3)}


def engines(name: str, kv: str, paged: bool):
    """(JAX engine, port engine) of the tiny `name` model."""
    seed, init = SEEDS[name]
    hf, sd = hf_checkpoint(name, seed, initializer_range=init)
    jspec, tspec = _specs(32)
    jcfg, tcfg = j_arch(hf), arch_from_hf_config(hf)
    if kv == "int8":
        jcfg = dataclasses.replace(jcfg, kv_append="plain")
        tcfg = dataclasses.replace(tcfg, kv_append="plain")
    jp = JH.params_from_state_dict(sd, jcfg, jspec)
    tp = TH.params_from_state_dict(sd, tcfg, tspec, device="cpu")
    kw = dict(max_batch=len(prompts(name)), max_len=128)
    if kv == "int8":
        kw["kv_quantized"] = True
    if paged:
        kw.update(page_size=16, n_pages=14)
        return (JPagedEngine(jp, jcfg, **kw),
                PagedEngine(tp, tcfg, device="cpu", **kw))
    return JEngine(jp, jcfg, **kw), Engine(tp, tcfg, device="cpu", **kw)


def prompts(name: str):
    return PROMPTS if name in RAGGED else PROMPTS[:1]


def check_arch(name: str, kv: str, paged: bool = False) -> None:
    je, pe = engines(name, kv, paged)
    batch = prompts(name)
    want_dtype = torch.int8 if kv == "int8" else torch.bfloat16
    k = pe.cache.k_pages if paged else pe.cache.k
    assert k.dtype == want_dtype and pe.cache.quantized == (kv == "int8")
    jk = je.cache.k_pages if paged else je.cache.k
    assert str(jk.dtype) == str(want_dtype).split(".")[-1]
    jl = np.asarray(je.prefill(batch), np.float32)
    pl = pe.prefill(batch).numpy()
    active = np.ones(len(batch), bool)
    for step in range(STEPS + 1):
        np.testing.assert_allclose(pl, jl, rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"{name} step {step}")
        top2 = np.sort(jl, axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > LOGIT_TOL), (name, step)
        jid, pid = jl.argmax(-1), pl.argmax(-1)
        np.testing.assert_array_equal(pid, jid, err_msg=f"{name} {step}")
        if step == STEPS:
            break
        jl = np.asarray(je.decode(jnp.asarray(jid, jnp.int32),
                                  jnp.asarray(active)), np.float32)
        pl = pe.decode(torch.from_numpy(pid.astype(np.int32)),
                       torch.from_numpy(active)).numpy()
