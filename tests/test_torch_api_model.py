"""`api.Model` and `api.ModelServer` in both packages, on the CPU.

The model is a tiny llama drawn by `transformers`' own init
(`tests/test_torch_hf.hf_checkpoint`: 2 layers, hidden 64, vocab 256, at
initializer range 0.45) and written as a local checkpoint directory
(`config.json` and `model.safetensors`).  The port's `Model().init` reads
that directory (int4 g32, bf16 scales); the JAX `Model` is built from the
same state dict through its converter and `_make_engine` (its `init` reads
the config through `transformers`).  JAX runs under `NST_FLASH=interpret`
(its Pallas kernels, the fused append).  The params seed (184) was searched
on the CPU so that every step's top-2 margin of the penalized logits
(repetition penalty 1.1, `generate`'s default) stays above LOGIT_TOL over
6 tokens of both prompts; each test that compares ids asserts it.

Held: `generate`'s ids equal the JAX package's (contiguous and paged,
bf16 and int8 caches; the streamer and `stopping_criteria`,
`tests/test_serving.py:166`), `__call__`'s logits within LOGIT_TOL with
-inf on the padding rows, `ModelServer`'s callbacks equal to per-prompt
`generate` (`:142`) and to the JAX server's, `join` re-raising a worker
error, a GGUF file through `init_from_gguf`, and each refusal naming its
ROADMAP item.
"""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from neural_speed_tpu import api as japi
from neural_speed_tpu.convert import gguf as JG
from neural_speed_tpu.convert import hf as JH
from neural_speed_tpu.models.configs import arch_from_hf_config as j_arch
from neural_speed_tpu_torch import api
from neural_speed_tpu_torch.utils.synthetic import write_safetensors

from tests.test_torch_gguf import (HF as GGUF_HF, MODELS as GGUF_MODELS,
                                   PROMPTS as GGUF_PROMPTS,
                                   _state_dict as gguf_sd)
from tests.test_torch_hf import _specs, hf_checkpoint
from tests.torch_hf_models import SEEDS as HF_SEEDS
from tests.test_torch_scheduler import _Margins

torch.set_num_threads(1)

LOGIT_TOL = 0.2
SEED, INIT = 184, 0.45
PROMPTS = [[1, 5, 9, 17, 33, 4, 250, 7, 19, 60], [3, 90, 200, 11]]
NEW = 6
CTX = 256


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")
    monkeypatch.setenv("NEURAL_SPEED_VERBOSE", "-1")


def _checkpoint(tmp_path_factory, seed, init):
    """(directory, HF config, state dict) of the tiny llama."""
    hf, sd = hf_checkpoint("llama", seed, initializer_range=init)
    d = tmp_path_factory.mktemp("tiny_llama")
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf, f, default=str)
    write_safetensors(os.path.join(d, "model.safetensors"), sd)
    return str(d), hf, sd


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _checkpoint(tmp_path_factory, SEED, INIT)


@pytest.fixture(scope="module")
def ckpt_small(tmp_path_factory):
    """The llama of `tests/torch_hf_models.py` (initializer range 0.2): its
    logits (|logit| ~6-8) stay within LOGIT_TOL of JAX's at every row; at
    range 0.45 they reach ~0.5 apart where the JAX CPU path rounds the
    dequantized weights of a product of at most 32 rows to bf16 and the
    port does not."""
    return _checkpoint(tmp_path_factory, *HF_SEEDS["llama"])


def join(srv, timeout: float = 300.0) -> None:
    """`srv.join()` bounded in time: a server that hangs fails the test
    instead of stalling the suite; the worker's error is re-raised."""
    box = {}

    def run():
        try:
            srv.join()
        except BaseException as e:  # handed to the test thread below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "ModelServer.join did not return"
    if "err" in box:
        raise box["err"]


def jax_model(ckpt, kv_quantized=False, paged=False):
    _, hf, sd = ckpt
    m = japi.Model()
    m.cfg = j_arch(hf)
    m._make_engine(JH.params_from_state_dict(sd, m.cfg, _specs(32)[0]), 2,
                   CTX, kv_quantized, paged=paged)
    return m


def port_model(ckpt, kv_quantized=False, **kw):
    return api.Model().init(ckpt[0], weight_dtype="int4", group_size=32,
                            scale_dtype="bf16", max_batch=2, ctx_size=CTX,
                            kv_quantized=kv_quantized, device="cpu", **kw)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("kv_quantized", [False, True], ids=["bf16", "int8"])
def test_init_and_generate_match_jax(ckpt, kv_quantized, paged, monkeypatch):
    """`Model.init` from the directory, then `generate` (greedy, repetition
    penalty 1.1): the JAX `Model`'s ids, with and without the prompt."""
    margins = _Margins(monkeypatch)
    m = port_model(ckpt, kv_quantized, paged=paged, page_size=128)
    assert type(m.engine).__name__ == ("PagedEngine" if paged else "Engine")
    assert m.engine.kv_quantized == kv_quantized and m.eos_id is None
    want = jax_model(ckpt, kv_quantized, paged).generate(
        PROMPTS, max_new_tokens=NEW, ignore_prompt=True)
    got = m.generate(PROMPTS, max_new_tokens=NEW, ignore_prompt=True)
    assert got == want and all(len(g) == NEW for g in got)
    full = m.generate(PROMPTS, max_new_tokens=NEW)
    assert full == [p + g for p, g in zip(PROMPTS, got)]
    margins.check()


def test_streamer_and_stopping_criteria(ckpt, monkeypatch):
    """`tests/test_serving.py:166`: the streamer sees every token in order;
    `stopping_criteria` stops the request between tokens; JAX gives the same
    tokens and streams."""
    margins = _Margins(monkeypatch)
    runs = []
    for m in (jax_model(ckpt, True), port_model(ckpt, True)):
        seen = []
        out = m.generate(
            [PROMPTS[0]], max_new_tokens=NEW, ignore_prompt=True,
            streamer=seen.append,
            stopping_criteria=lambda ids: len(ids) >= len(PROMPTS[0]) + 3)[0]
        # the criteria stop at 3 tokens, one more may be in flight
        assert len(out) <= 4 and seen == out
        streamed = []
        full = m.generate([PROMPTS[1]], max_new_tokens=NEW,
                          ignore_prompt=True, streamer=streamed.append)[0]
        assert streamed == full
        runs.append((out, full))
    assert runs[0] == runs[1]
    margins.check()


@pytest.mark.parametrize("kv_quantized", [False, True], ids=["bf16", "int8"])
def test_call_logits_match_jax(ckpt_small, kv_quantized):
    """`__call__`: float32 logits [B, T, V] within LOGIT_TOL of JAX's on the
    prompt rows, -inf on every padding row, as the JAX `Model`."""
    want = jax_model(ckpt_small, kv_quantized)(PROMPTS)
    got = port_model(ckpt_small, kv_quantized)(np.asarray(PROMPTS[1]))
    assert got.shape == (1, len(PROMPTS[1]), 256)
    got = port_model(ckpt_small, kv_quantized)(PROMPTS)
    assert got.shape == want.shape == (2, len(PROMPTS[0]), 256)
    assert got.dtype == np.float32
    pad = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), pad)
    assert pad[1, len(PROMPTS[1]):].all() and not pad[0].any()
    np.testing.assert_allclose(got[~pad], want[~pad], rtol=0, atol=LOGIT_TOL)


def test_model_server_matches_generate_and_jax(ckpt, monkeypatch):
    """`tests/test_serving.py:142`: `ModelServer`'s callbacks (one per
    request, by request id) equal per-prompt `generate` and the JAX
    server's."""
    margins = _Margins(monkeypatch)
    m = port_model(ckpt, True, paged=True)
    ref = [m.generate([p], max_new_tokens=NEW, ignore_prompt=True)[0]
           for p in PROMPTS]
    outs = []
    for mk, srv_cls in ((lambda: jax_model(ckpt, True, True),
                         japi.ModelServer),
                        (lambda: port_model(ckpt, True, paged=True),
                         api.ModelServer)):
        results, lock = {}, threading.Lock()

        def cb(rid, toks):
            with lock:
                results[rid] = list(toks)

        with srv_cls(mk(), cb, max_new_tokens=NEW) as srv:
            for p in PROMPTS:
                srv.issue_query(p)
            srv.issue_query(PROMPTS[0], max_new_tokens=2)
            join(srv)
        outs.append(results)
    assert outs[1] == outs[0]
    assert [outs[1][i] for i in range(len(PROMPTS))] == ref
    assert outs[1][2] == ref[0][:2]
    margins.check()


def test_server_join_reraises_a_worker_error(ckpt):
    """A failing response callback stops the worker; `join` raises its
    error (and does not wait for queries the worker never took)."""
    m = port_model(ckpt)

    def cb(rid, toks):
        raise RuntimeError("callback failed")

    with api.ModelServer(m, cb, max_new_tokens=2) as srv:
        srv.issue_query(PROMPTS[0])
        srv.issue_query(PROMPTS[1])
        with pytest.raises(RuntimeError, match="callback failed"):
            join(srv)


def test_server_join_waits_for_the_last_callbacks(ckpt):
    """`join` returns only after the response callbacks of the requests
    that finish in the worker's last step have returned (the scheduler has
    no work left before they run)."""
    m = port_model(ckpt)
    got = []

    def cb(rid, toks):
        time.sleep(0.2)
        got.append(rid)

    with api.ModelServer(m, cb, max_new_tokens=2) as srv:
        srv.issue_query(PROMPTS[0])
        srv.issue_query(PROMPTS[1])
        join(srv)
        assert sorted(got) == [0, 1]


def test_server_runs_the_scheduler_in_inference_mode(ckpt):
    """PyTorch's inference mode is per thread: the worker enters it."""
    m = port_model(ckpt)
    modes = []
    with api.ModelServer(m, lambda rid, toks: modes.append(
            torch.is_inference_mode_enabled()), max_new_tokens=2) as srv:
        srv.issue_query(PROMPTS[1])
        join(srv)
    assert modes == [True] and not torch.is_inference_mode_enabled()


def test_init_from_gguf_matches_jax(tmp_path, monkeypatch):
    """A llama GGUF file (Q4_0, written by the JAX package's writer) through
    `init_from_gguf` in both packages: the same ids over the int8 cache
    (greedy without the repetition penalty: the seed, prompts, steps and
    tolerance of `tests/test_torch_gguf.py::MODELS`)."""
    margins = _Margins(monkeypatch)
    seed, tol = GGUF_MODELS["llama-Q4_0"]
    path = str(tmp_path / "m.gguf")
    JG.write_hf_to_gguf(gguf_sd(GGUF_HF, seed), dict(
        {"model_type": "llama"}, **GGUF_HF), path, ggml_type=JG.GGML_Q4_0)
    prompts = [GGUF_PROMPTS[0], GGUF_PROMPTS[2]]
    kw = dict(max_batch=2, ctx_size=CTX, kv_quantized=True)
    gen = dict(max_new_tokens=6, ignore_prompt=True, repetition_penalty=1.0)
    want = japi.Model().init_from_gguf(path, **kw).generate(prompts, **gen)
    m = api.Model().init_from_gguf(path, device="cpu", **kw)
    assert m.engine.cfg.name == "llama" and m.tokenizer is None
    assert m.generate(prompts, **gen) == want
    margins.check(tol)


def test_engine_options(ckpt):
    """`memory_dtype` picks the KV type (int8: the quantized cache; f32;
    unknown ones raise); a tokenizer sets `eos_id` and backs `tokenize` /
    `detokenize`; without `device` the model goes to the card, which this
    machine does not have."""
    m = port_model(ckpt, memory_dtype="int8")
    assert m.engine.kv_quantized and m.engine.cache.k.dtype == torch.int8
    m = port_model(ckpt, memory_dtype="f32")
    assert m.engine.cache.k.dtype == torch.float32
    with pytest.raises(ValueError, match="memory_dtype"):
        port_model(ckpt, memory_dtype="f8")

    @dataclasses.dataclass
    class Tok:
        eos_token_id: int = 7

        def __call__(self, text):
            return {"input_ids": [ord(c) % 256 for c in text]}

        def decode(self, ids):
            return "".join(chr(i) for i in ids)

    m = port_model(ckpt, tokenizer=Tok())
    assert m.eos_id == 7
    assert m.detokenize(m.tokenize("abc")) == "abc"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.Model().init(ckpt[0], group_size=32)


def test_init_converts_on_the_resolved_device(ckpt, monkeypatch):
    """Without `device`, `Model.init` resolves the card before it reads the
    checkpoint, and converts and quantizes the weights there: with no card
    it raises before loading; with one, the converter is handed the card."""
    from neural_speed_tpu_torch.convert import hf as TH
    from neural_speed_tpu_torch.convert import loaders as TL

    def load(path):
        raise AssertionError("the checkpoint was read before the device "
                             "was resolved")

    with monkeypatch.context() as mp:
        mp.setattr(TL, "load_state_dict", load)
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.Model().init(ckpt[0], group_size=32)
    seen = []

    class Stop(Exception):
        pass

    def convert(sd, cfg, qspec, device=None, **kw):
        seen.append(device)
        raise Stop  # before any tensor is placed

    monkeypatch.setattr(TH, "params_from_state_dict", convert)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(Stop):
        api.Model().init(ckpt[0], group_size=32)
    assert seen == [torch.device("cuda")]


def test_refusals_name_their_item(ckpt, monkeypatch):
    """What is not ported raises, naming its ROADMAP section 1 item;
    `generate(speculative=True)` and `ModelServer(speculative=True)` /
    `(mixed_prefill=True)` run, their ids those of the plain path, and
    their attention lands where `flash.int8_dot` says (the bf16 cache: the
    verify and prefill chunks of several tokens at kernel C's plain
    version, no int8 dot)."""
    margins = _Margins(monkeypatch)
    d = ckpt[0]
    m = port_model(ckpt)
    cases = [
        (lambda: api.Model().init(d, use_cache=True, device="cpu"), 6),
        (lambda: api.Model().init(d, lora_path="x", device="cpu"), 8),
        (lambda: api.Model().init(d, tp=2, device="cpu"), 9),
        (lambda: api.Model().init(d, prefix_cache=True, paged=True,
                                  device="cpu"), 5),
        (lambda: api.Model().init_from_bin(None, "x.bin"), 8),
        (lambda: api.Model().init_from_ne_bin("x.bin"), 8),
        (lambda: m.generate(PROMPTS, num_beams=2), 5),
        (lambda: m.generate(PROMPTS, session_path="s"), 6),
        (lambda: m.quant_model("q"), 6),
        (lambda: m.save_state("s"), 6),
        (lambda: m.load_state("s"), 6),
        (lambda: api.ModelServer(m, print, num_beams=2), 5),
    ]
    for fn, item in cases:
        with pytest.raises(NotImplementedError, match=f"item {item}\\b"):
            fn()
    with api.ModelServer(m, print) as srv:
        with pytest.raises(NotImplementedError, match="item 6"):
            srv.save_state("s")
    from neural_speed_tpu_torch import _build

    plain = m.generate(PROMPTS, max_new_tokens=NEW, ignore_prompt=True)
    before = dict(_build.plain_dispatches)
    assert m.generate(PROMPTS, max_new_tokens=NEW, ignore_prompt=True,
                      speculative=True) == plain
    for kw in (dict(speculative=True), dict(mixed_prefill=True,
                                            mixed_chunk=4)):
        if "mixed_prefill" in kw:
            # the mixed server decodes through the chunk ladder, whose
            # tokens past the budget are discarded: their margins are not
            # the ids'
            margins.check()
        got = {}
        with api.ModelServer(m, lambda rid, ids: got.setdefault(rid, ids),
                             max_new_tokens=NEW, **kw) as srv:
            for p in PROMPTS:
                srv.issue_query(p)
            srv.join()
        assert [got[i] for i in range(len(PROMPTS))] == plain
    grown = {n for n, c in _build.plain_dispatches.items()
             if c > before.get(n, 0)}
    assert "flash_prefill_bf16" in grown and not any(
        "_qk" in n for n in grown)
