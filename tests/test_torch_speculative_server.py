"""The whole slice on the CPU: a tiny llama (2 layers, 4 query heads over 4
KV heads of 64, so a verify step of t <= 8 tokens has t * n_rep <= 8 rows
per KV head) over the int8 cache with `NST_FLASH_INT8=qk` in both
packages, served by `ModelServer(speculative=True)` in each: identical
ids per request.

The params are drawn by the JAX package's `synth_params` (int4 g64, bf16
scales) and carried across, the embedding scaled by 50 and the final norm
by 4 as in `tests/test_torch_scheduler.py`; the seed was searched on the
CPU so that every pick's top-2 margin (the verify rows, the plain decode
rows and the prefill rows, the repetition penalty 1.1 of the server's
greedy default) stays above LOGIT_TOL (asserted).  The port's verify
steps run kernel B's int8 dot over several tokens per slot (its plain
version here: the `flash_decode_qk_multi` counter), JAX's through its
head-blocked Pallas body (`NST_FLASH=interpret`).
"""

import functools
import threading

import pytest
import torch

import jax

from neural_speed_tpu.models.arch import ArchConfig as JArchConfig
from neural_speed_tpu.ops import flash as jfl
from neural_speed_tpu.ops.qtypes import QSpec as JSpec, QType as JQType
from neural_speed_tpu.runtime.engine import Engine as JEngine
from neural_speed_tpu.runtime.server import ModelServer as JModelServer
from neural_speed_tpu.utils.synthetic import synth_params as jax_synth_params
from neural_speed_tpu_torch import _build, api
from neural_speed_tpu_torch.models.arch import ArchConfig
from neural_speed_tpu_torch.models.params import params_from_numpy
from neural_speed_tpu_torch.ops import flash as tfl
from neural_speed_tpu_torch.runtime.engine import Engine

from tests.test_torch_scheduler import _Margins
from tests.test_torch_speculative import HostMargins, _draws
from tests.torch_port_util import tree_to_numpy

torch.set_num_threads(1)

CFG = dict(name="llama", vocab_size=128, hidden_size=256, n_layers=2,
           n_heads=4, n_kv_heads=4, intermediate_size=448,
           max_position_embeddings=256)
MAX_LEN = 256
# The params seed and four random prompts (trials of `_draws(100 + SEED)`)
# whose sequential greedy margins over 24 tokens exceed 0.3, searched on
# the CPU; the generated text soon repeats, so drafts are accepted.
SEED, TRIALS = 3, (1, 10, 11, 16)
PROMPTS = [_draws(100 + SEED, 17)[i] for i in TRIALS]
BUDGETS = [24, 20, 16, 12]


@functools.lru_cache(maxsize=None)
def jax_params(seed: int = SEED):
    jcfg = JArchConfig(**CFG, kv_append="fused")
    jp = jax_synth_params(
        jcfg, JSpec(JQType.INT, 4, 64, True, scale_dtype="bfloat16"),
        seed=seed)
    jp["embed"]["weight"] = jp["embed"]["weight"] * 50.0
    jp["final_norm"]["weight"] = jp["final_norm"]["weight"] * 4.0
    return jcfg, jp


@pytest.fixture(autouse=True)
def _qk_on(monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")
    jax.clear_caches()
    monkeypatch.setattr(jfl, "FLASH_INT8_DOT", True)
    monkeypatch.setattr(tfl, "FLASH_INT8_DOT", True)
    yield
    jax.clear_caches()


def _serve(server_cls, engine, spec_k: int):
    got, lock = {}, threading.Lock()

    def respond(rid, ids):
        with lock:
            got[rid] = list(ids)

    srv = server_cls(engine, respond, speculative=True, spec_k=spec_k)
    try:
        for p, n in zip(PROMPTS, BUDGETS):
            srv.issue_query(p, max_new_tokens=n)
        srv.join()
    finally:
        srv.shutdown()
    return [got[i] for i in range(len(PROMPTS))]


def serve_both(seed: int = SEED, spec_k: int = 7):
    """(JAX ids, port ids) of the four requests over 2 slots each."""
    jcfg, jp = jax_params(seed)
    kw = dict(max_batch=2, max_len=MAX_LEN, kv_quantized=True)
    want = _serve(JModelServer, JEngine(jp, jcfg, **kw), spec_k)
    port = Engine(params_from_numpy(tree_to_numpy(jp), device="cpu"),
                  ArchConfig(**CFG, kv_append="fused"), device="cpu", **kw)
    got = _serve(api.ModelServer, port, spec_k)
    return want, got


def test_speculative_server_matches_jax(monkeypatch):
    margins = HostMargins(monkeypatch)
    dev_margins = _Margins(monkeypatch)
    before = dict(_build.plain_dispatches)
    want, got = serve_both()
    assert got == want
    assert [len(g) for g in got] == BUDGETS
    grown = {n: c - before.get(n, 0)
             for n, c in _build.plain_dispatches.items()
             if c > before.get(n, 0)}
    # the verify steps (2 to 8 tokens per slot) through the int8 dot
    assert grown.get("flash_decode_qk_multi", 0) > 0
    margins.check()
    dev_margins.check()
