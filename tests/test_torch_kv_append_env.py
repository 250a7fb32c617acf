"""The decode KV-append switch read from the env, in both packages.

`ArchConfig.kv_append = "env"` (the default) makes `Engine` and
`PagedEngine` resolve the mode once, at construction, from
`NST_KV_APPEND` (plain / defer / fused, taken as given) and the kill
switches `NST_DEFER_APPEND=0` / `NST_FUSED_APPEND=0` (both step down to
plain), and pin it into their config.  For each env value, a tiny llama
over the int8 cache (the paged engine's config and seed:
`tests/test_torch_paged_engine.py`) runs through both engines in both
packages: the port on the CPU with its plain versions, JAX on the CPU with
`NST_FLASH=interpret` (without it the JAX package never defers on the CPU,
and a deferring port would be held against JAX's plain logits).

Checked: the pinned `cfg.kv_append` equal in the two packages and to the
JAX rule's value; a ragged prefill and greedy decode steps with logits
within LOGIT_TOL (`tests/test_torch_model.py` states it) and greedy ids
identical, each step's top-2 margin above LOGIT_TOL.  "defer" runs kernel
B's extra-kv column and then the append on the contiguous cache; on the
page pool only "fused" defers, so "defer" runs plain there, as in the JAX
package.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.models import transformer as jtr
from neural_speed_tpu.models.arch import ArchConfig as JArchConfig
from neural_speed_tpu.runtime.engine import Engine as JEngine
from neural_speed_tpu.runtime.engine import PagedEngine as JPagedEngine
from neural_speed_tpu_torch.models import transformer as ttr
from neural_speed_tpu_torch.models.arch import ArchConfig
from neural_speed_tpu_torch.models.params import params_from_numpy
from neural_speed_tpu_torch.runtime.engine import Engine, PagedEngine

from tests.test_torch_model import LOGIT_TOL
from tests.test_torch_paged_engine import CFG, MAX_LEN, PROMPTS, _params
from tests.torch_port_util import tree_to_numpy

torch.set_num_threads(1)

ENV_VARS = ("NST_KV_APPEND", "NST_DEFER_APPEND", "NST_FUSED_APPEND")
# env setting -> the mode both engines pin
ENVS = {
    "NST_KV_APPEND=plain": "plain",
    "NST_KV_APPEND=defer": "defer",
    "NST_KV_APPEND=fused": "fused",
    "NST_DEFER_APPEND=0": "plain",
    "NST_FUSED_APPEND=0": "plain",
}
STEPS = 4


def _set_env(monkeypatch, env: str) -> None:
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    var, _, value = env.partition("=")
    monkeypatch.setenv(var, value)
    monkeypatch.setenv("NST_FLASH", "interpret")


@pytest.mark.parametrize("env", sorted(ENVS))
def test_kv_append_mode_resolves_the_env_as_jax(env, monkeypatch):
    _set_env(monkeypatch, env)
    assert ttr.kv_append_mode() == jtr.kv_append_mode() == ENVS[env]


def test_unset_env_resolves_to_fused(monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    assert ttr.kv_append_mode() == jtr.kv_append_mode() == "fused"


@pytest.mark.parametrize("paged", [False, True], ids=["engine", "paged"])
@pytest.mark.parametrize("env", sorted(ENVS))
def test_engines_pin_the_env_mode_and_match_jax(env, paged, monkeypatch):
    _set_env(monkeypatch, env)
    _, jp = _params()
    jcfg = JArchConfig(**CFG)                       # kv_append="env"
    tparams = params_from_numpy(tree_to_numpy(jp), device="cpu")
    kw = dict(max_batch=2, max_len=MAX_LEN, kv_quantized=True)
    if paged:
        kw.update(page_size=128, n_pages=3)
        je = JPagedEngine(jp, jcfg, **kw)
        pe = PagedEngine(tparams, ArchConfig(**CFG), device="cpu", **kw)
    else:
        je = JEngine(jp, jcfg, **kw)
        pe = Engine(tparams, ArchConfig(**CFG), device="cpu", **kw)
    assert pe.cfg.kv_append == je.cfg.kv_append == ENVS[env]

    both = np.array([True, True])
    jl = np.asarray(je.prefill(PROMPTS), np.float32)
    pl = pe.prefill(PROMPTS).numpy()
    for step in range(STEPS + 1):
        np.testing.assert_allclose(pl, jl, rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"step {step}")
        top2 = np.sort(jl, axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > LOGIT_TOL), step
        ids = jl.argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(pl.argmax(-1), ids)
        if step == STEPS:
            break
        jl = np.asarray(je.decode(jnp.asarray(ids), jnp.asarray(both)),
                        np.float32)
        pl = pe.decode(torch.from_numpy(ids),
                       torch.from_numpy(both)).numpy()


def test_defer_runs_kernel_b_then_the_append(monkeypatch):
    """On the contiguous int8 cache "defer" gives "fused"'s logits and
    cache bytes (the same attention over the unquantized new row, the same
    quantized append), and differs from "plain" (which attends over the
    quantized row)."""
    _, jp = _params()
    tparams = params_from_numpy(tree_to_numpy(jp), device="cpu")
    runs = {}
    for mode in ("plain", "defer", "fused"):
        pe = Engine(tparams, ArchConfig(**CFG, kv_append=mode), max_batch=2,
                    max_len=MAX_LEN, kv_quantized=True, device="cpu")
        ids = pe.prefill(PROMPTS).argmax(-1).to(torch.int32)
        runs[mode] = (pe.decode(ids, torch.ones(2, dtype=torch.bool)),
                      pe.cache)
    (ld, cd), (lf, cf), (lp, _) = runs["defer"], runs["fused"], runs["plain"]
    assert torch.equal(ld, lf)
    for name in ("k", "v", "k_scale", "v_scale", "lengths"):
        assert torch.equal(getattr(cd, name), getattr(cf, name)), name
    assert not torch.equal(ld, lp)


def test_unknown_mode_raises():
    cfg = ArchConfig(**CFG, kv_append="later")
    with pytest.raises(ValueError, match="kv_append"):
        ttr._resolved_kv_append(cfg)
