"""The port's `ContinuousBatchingScheduler` against the JAX package's, on the
CPU: the same params (a tiny llama, 2 layers, 8 query heads over 4 KV
heads, drawn by the JAX package's `synth_params` and carried across), the
same requests, JAX under `NST_FLASH=interpret` (its Pallas kernels, the
fused append; at page size 16 its XLA path).

* The matrix: `Engine` and `PagedEngine` (page size 16 and 128, in
  `tests/test_torch_scheduler_paged.py`), bf16 and int8 caches, the window
  path and the chunk ladder (`window=1`), with `pipeline_decode` on and
  off; 5 requests over 2 slots.  Per request the greedy `generated` lists
  are identical and so is the finish order.
* The draw is chosen so that greedy decoding is not near a tie: the
  embedding is scaled by 50 (random 0.02-scale embeddings leave every
  context with the same argmax) and the final norm by 4, and the params
  seed (65) was searched so that every step's top-2 margin of the
  penalized logits (repetition penalty 1.1, the scheduler's default) stays
  above LOGIT_TOL; each test asserts it (`_margins`).
* The JAX scheduler's own properties: staggered admission
  (`tests/test_serving.py:116`), an `eos_id` that occurs, with a
  first-token finish and the paged pool released (`:612`), streamer order,
  `warmup` leaving deliveries identical, windows smaller than the chunk
  (`tests/test_decode_window.py`).
* Sampled decoding: a seed gives the same ids run after run (the port's
  generator, not JAX's numbers), and `temperature <= 0` is greedy.
* `NST_FLASH_INT8=qk` (JAX's flag patched, caches cleared): the int8
  contiguous and paged engines give JAX's greedy ids, and the port's
  `_qk` plain versions ran.
* Speculative and mixed scheduling run (`tests/test_torch_speculative.py`
  and `test_torch_mixed_prefill.py` hold them against JAX); what is not
  ported raises, naming its ROADMAP item.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from neural_speed_tpu.models.arch import ArchConfig as JArchConfig
from neural_speed_tpu.ops import flash as jfl
from neural_speed_tpu.ops.qtypes import QSpec as JSpec, QType as JQType
from neural_speed_tpu.ops.sampling import SamplingParams as JSamplingParams
from neural_speed_tpu.runtime.engine import (Engine as JEngine,
                                             PagedEngine as JPagedEngine)
from neural_speed_tpu.runtime.scheduler import (
    ContinuousBatchingScheduler as JScheduler)
from neural_speed_tpu.utils.synthetic import synth_params as jax_synth_params
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch.models.arch import ArchConfig
from neural_speed_tpu_torch.models.params import params_from_numpy
from neural_speed_tpu_torch.ops import flash as tfl
from neural_speed_tpu_torch.ops import sampling as tsmp
from neural_speed_tpu_torch.runtime.engine import Engine, PagedEngine
from neural_speed_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler, SeqStatus)

from tests.torch_port_util import tree_to_numpy

torch.set_num_threads(1)

LOGIT_TOL = 0.2
CFG = dict(name="llama", vocab_size=128, hidden_size=256, n_layers=2,
           n_heads=8, n_kv_heads=4, intermediate_size=448,
           max_position_embeddings=256)
MAX_LEN = 256
SEED, EMBED_SCALE, FINAL_NORM_SCALE = 65, 50.0, 4.0
_rng = np.random.default_rng(1)
PROMPTS = [[int(t) for t in _rng.integers(1, 128, n)]
           for n in (9, 40, 124, 17, 70)]
BUDGETS = [6, 12, 9, 4, 10]


@functools.lru_cache(maxsize=None)
def jax_params():
    jcfg = JArchConfig(**CFG, kv_append="fused")
    jp = jax_synth_params(
        jcfg, JSpec(JQType.INT, 4, 64, True, scale_dtype="bfloat16"),
        seed=SEED)
    jp["embed"]["weight"] = jp["embed"]["weight"] * EMBED_SCALE
    jp["final_norm"]["weight"] = jp["final_norm"]["weight"] * FINAL_NORM_SCALE
    return jcfg, jp


def port_params():
    return params_from_numpy(tree_to_numpy(jax_params()[1]), device="cpu")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")


def engines(kind, kv_quantized: bool, max_batch: int = 2):
    """The JAX engine and the port's: kind "contiguous" or a page size."""
    jcfg, jp = jax_params()
    kw = dict(max_batch=max_batch, max_len=MAX_LEN, kv_quantized=kv_quantized)
    cfg = ArchConfig(**CFG, kv_append="fused")
    if kind == "contiguous":
        return (JEngine(jp, jcfg, **kw),
                Engine(port_params(), cfg, device="cpu", **kw))
    return (JPagedEngine(jp, jcfg, page_size=kind, **kw),
            PagedEngine(port_params(), cfg, page_size=kind, device="cpu",
                        **kw))


class _Margins:
    """Wraps the port's `sampling.sample`: the top-2 margin of the
    penalized logits of every active row at every call."""

    def __init__(self, monkeypatch):
        self.seen = []
        orig = tsmp.sample

        def sample(logits, state, p, active=None):
            lg = tsmp.apply_penalties(logits.float(), state, p)
            rows = lg if active is None else lg[active]
            if rows.shape[0]:
                top2 = torch.topk(rows, 2, dim=-1).values
                self.seen.append((top2[:, 0] - top2[:, 1]).min().item())
            return orig(logits, state, p, active)

        monkeypatch.setattr(tsmp, "sample", sample)

    def check(self, tol: float = LOGIT_TOL):
        assert self.seen and min(self.seen) > tol, min(self.seen)


def serve(sched, prompts=PROMPTS, budgets=BUDGETS, streams=None):
    """Queue the requests, run to completion; returns [(request id,
    generated)] in finish order."""
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        cb = None if streams is None else streams.setdefault(i, []).append
        sched.add_request(p, b, streamer=cb)
    return [(s.request_id, s.generated) for s in sched.run_to_completion()]


def _pool_free(eng) -> bool:
    return eng._alloc.available == eng.n_pages - 1


def check_matrix_case(kind, kv_quantized, window, pipeline, monkeypatch):
    """Greedy deliveries and finish order equal to the JAX scheduler's, for
    one engine, cache and decode-path combination."""
    je, pe = engines(kind, kv_quantized)
    margins = _Margins(monkeypatch)
    want = serve(JScheduler(je, window=window, pipeline_decode=pipeline))
    sched = ContinuousBatchingScheduler(pe, window=window,
                                        pipeline_decode=pipeline)
    assert sched._use_window() == (window is None)
    got = serve(sched)
    assert got == want
    assert [len(g) for _, g in sorted(got)] == BUDGETS
    margins.check()
    if kind != "contiguous":
        assert _pool_free(pe) and _pool_free(je)


MATRIX = dict(
    argnames="kv_quantized,window,pipeline",
    argvalues=[(kv, w, p) for kv in (False, True) for w in (None, 1)
               for p in (True, False)],
    ids=[f"{kv}-{w}-{p}" for kv in ("bf16", "int8")
         for w in ("window", "chunk") for p in ("pipe", "nopipe")])


@pytest.mark.parametrize(**MATRIX)
def test_scheduler_matches_jax(kv_quantized, window, pipeline, monkeypatch):
    """The contiguous `Engine` (the page pool's half of the matrix is
    `tests/test_torch_scheduler_paged.py`)."""
    check_matrix_case("contiguous", kv_quantized, window, pipeline,
                      monkeypatch)


def test_staggered_admission_matches_jax(monkeypatch):
    """Requests arriving mid-flight (`tests/test_serving.py:116`): both
    schedulers stepped in the same pattern give the same deliveries, equal
    to each request served alone."""
    margins = _Margins(monkeypatch)
    runs = []
    for je_or_pe in engines(128, True):
        cls = (ContinuousBatchingScheduler
               if isinstance(je_or_pe, PagedEngine) else JScheduler)
        sched = cls(je_or_pe)
        out = {}
        rids = [sched.add_request(PROMPTS[0], 6)]
        sched.step()  # prefill request 0
        sched.step()  # decode
        rids.append(sched.add_request(PROMPTS[1], 6))
        sched.step()  # prefill request 1 (request 0 keeps its KV)
        sched.step()
        rids.append(sched.add_request(PROMPTS[3], 6))
        while sched.has_work:
            sched.step()
            for s in sched.pop_finished():
                out[s.request_id] = s.generated
        runs.append([out[r] for r in rids])
    assert runs[0] == runs[1]
    _, pe = engines(128, True)
    alone = [serve(ContinuousBatchingScheduler(pe), [p], [6])[0][1]
             for p in (PROMPTS[0], PROMPTS[1], PROMPTS[3])]
    assert runs[1] == alone
    margins.check()


@pytest.mark.parametrize("kind", ["contiguous", 128])
def test_eos_first_token_and_streamer_order(kind, monkeypatch):
    """An `eos_id` that occurs: a request whose first token is EOS finishes
    at once (FINISHED, one token), others stop at their first EOS; the
    streamer sees each request's tokens in order; the page pool is free at
    the end (`tests/test_serving.py:612`); JAX delivers the same."""
    margins = _Margins(monkeypatch)
    je, pe = engines(kind, True)
    first = serve(ContinuousBatchingScheduler(pe))
    eos = dict(first)[2][0]               # request 2's first token
    je, pe = engines(kind, True)
    want = serve(JScheduler(je, eos_id=eos))
    streams = {}
    sched = ContinuousBatchingScheduler(pe, eos_id=eos)
    for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS)):
        sched.add_request(p, b, streamer=streams.setdefault(i, []).append)
    done = sched.run_to_completion()
    got = [(s.request_id, s.generated) for s in done]
    assert got == want
    by_id = {s.request_id: s for s in done}
    assert by_id[2].generated == [eos]
    assert all(s.status == SeqStatus.FINISHED for s in done)
    for rid, gen in got:
        assert streams[rid] == gen
        assert eos not in gen[:-1]
        assert gen[-1] == eos or len(gen) == BUDGETS[rid]
    if kind != "contiguous":
        assert _pool_free(pe)
    margins.check()


def test_warmup_leaves_deliveries_identical(monkeypatch):
    """A warmed-up scheduler delivers what a cold one does."""
    _, pe = engines(128, True)
    cold = serve(ContinuousBatchingScheduler(pe))
    _, pe = engines(128, True)
    sched = ContinuousBatchingScheduler(pe)
    sched.warmup(prompt_len=20)
    assert not sched.has_work and sched.timings.decode_tokens == 0
    assert _pool_free(pe)
    # request ids continue after the warmup's, as in the JAX package
    warm = serve(sched)
    assert [rid for rid, _ in warm] == [rid + 1 for rid, _ in cold]
    assert [g for _, g in warm] == [g for _, g in cold]


@pytest.mark.parametrize("window,chunk", [(3, 8), (5, 4), (2, 16)])
def test_windows_smaller_than_the_chunk(window, chunk, monkeypatch):
    """Window caps below and above the chunk (`tests/test_decode_window.
    py`): the same deliveries as JAX's and as per-token stepping."""
    margins = _Margins(monkeypatch)
    je, pe = engines("contiguous", True)
    want = serve(JScheduler(je, window=window, chunk_size=chunk))
    got = serve(ContinuousBatchingScheduler(pe, window=window,
                                            chunk_size=chunk))
    assert got == want
    _, pe = engines("contiguous", True)
    assert serve(ContinuousBatchingScheduler(pe, chunk_size=1)) == got
    margins.check()


def test_sampled_decoding_is_seeded_and_temperature_zero_is_greedy():
    """Sampled ids are the port's own: one seed gives the same ids run after
    run, another seed other ids; do_sample with temperature <= 0 equals
    greedy (same penalty)."""
    sp = tsmp.SamplingParams(do_sample=True, temperature=1.5, top_k=0,
                             top_p=1.0)

    def run(seed, params):
        _, pe = engines(128, True)
        return serve(ContinuousBatchingScheduler(pe, params, seed=seed))

    a, b, c = run(3, sp), run(3, sp), run(4, sp)
    assert a == b and a != c
    greedy = run(0, tsmp.SamplingParams(do_sample=False))
    zero = run(0, tsmp.SamplingParams(do_sample=True, temperature=0.0))
    assert zero == greedy


def test_qk_matches_jax(monkeypatch):
    """NST_FLASH_INT8=qk: the int8 contiguous and paged engines give the
    JAX package's greedy ids; the port's int8-dot plain versions ran."""
    jax.clear_caches()
    monkeypatch.setattr(jfl, "FLASH_INT8_DOT", True)
    monkeypatch.setattr(tfl, "FLASH_INT8_DOT", True)
    margins = _Margins(monkeypatch)
    try:
        for kind, counter in (("contiguous", "flash_decode_qk"),
                              (128, "flash_decode_paged_qk")):
            je, pe = engines(kind, True)
            want = serve(JScheduler(je))
            before = _build.plain_dispatches[counter]
            assert serve(ContinuousBatchingScheduler(pe)) == want
            assert _build.plain_dispatches[counter] > before
    finally:
        jax.clear_caches()
    margins.check()


def test_refusals_name_their_item():
    """Speculative and mixed scheduling run (their joint steps' attention
    lands where `flash.int8_dot` says: with the int8 dot off, the verify
    and prefill chunks of several tokens go to kernel C's plain version);
    what is not ported raises, naming the ROADMAP item: eviction when a
    slot's context fills (6, before any state changes), checkpoints (6)."""
    _, pe = engines("contiguous", True)
    for kw in (dict(speculative=True), dict(mixed_prefill=True,
                                            mixed_chunk=16)):
        before = dict(_build.plain_dispatches)
        sched = ContinuousBatchingScheduler(pe, **kw)
        got = serve(sched, PROMPTS[:2], BUDGETS[:2])
        assert [len(g) for _, g in sorted(got)] == BUDGETS[:2]
        grown = {n for n, c in _build.plain_dispatches.items()
                 if c > before.get(n, 0)}
        assert "flash_prefill" in grown and not any(
            n.endswith(("_qk", "_qk_multi")) for n in grown)
    sched = ContinuousBatchingScheduler(pe)
    with pytest.raises(NotImplementedError, match="item 6"):
        sched.save_state("x")
    with pytest.raises(NotImplementedError, match="item 6"):
        ContinuousBatchingScheduler.load_state(pe, "x")
    # a request whose budget runs past the context
    sched.add_request(PROMPTS[2], MAX_LEN)
    sched.step()                                  # prefill
    lens = sched._slot_len.copy()
    with pytest.raises(NotImplementedError, match="item 6"):
        while sched.has_work:
            lens = sched._slot_len.copy()
            sched.step()
    assert lens.max() + sched.window_cap > MAX_LEN - 1
    # the eviction check raised before the failing step changed the mirror
    np.testing.assert_array_equal(sched._slot_len, lens)


def test_jax_sampling_params_defaults_match():
    """The scheduler's default params (greedy, repetition penalty 1.1) are
    the JAX package's."""
    import dataclasses

    j = dataclasses.asdict(JSamplingParams(do_sample=False))
    t = dataclasses.asdict(tsmp.SamplingParams(do_sample=False))
    assert j == t
