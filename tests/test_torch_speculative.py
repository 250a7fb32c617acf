"""Prompt-lookup speculative decoding in the port (`runtime/speculative.py`,
the scheduler's joint steps, `api.Model.generate(speculative=True)`)
against the JAX package's, on the CPU: the cases of `tests/
test_speculative.py`, each held against the JAX functions.

The model is `tests/test_torch_scheduler.py`'s tiny llama (2 layers, 8
query heads over 4 KV heads, its params drawn by the JAX package's
`synth_params` under the searched seed 65 and carried across), JAX under
`NST_FLASH=interpret`.  The prompts are random (vocabulary 128, so
1-gram drafts fire, and the generated text soon repeats, so drafts are
accepted), searched so that greedy ids are held clear of ties
(`SPEC_PROMPTS`): every argmax the port takes (a verify row, a plain
decode row or a host pick) has a top-2 margin above LOGIT_TOL
(`HostMargins`, beside `_Margins` for the device sampler of prefill and
backoff steps).

Sampled speculation draws from `numpy.random.default_rng` in both
packages, so with equal logits it emits equal tokens; the logits differ in
the last bits, so the token-for-token check runs on seeds where every draw
clears its decision boundary by more than the L1 distance between the two
packages' target distributions (`_DrawLog`), and the statistical check is
JAX's: per-position marginals of sampled speculation against sequential
sampling within 0.15 total variation.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from neural_speed_tpu import api as japi
from neural_speed_tpu.ops.sampling import SamplingParams as JSP
from neural_speed_tpu.runtime import speculative as jsp
from neural_speed_tpu_torch import api
from neural_speed_tpu_torch.ops import sampling as tsmp
from neural_speed_tpu_torch.runtime import speculative as tsp
from neural_speed_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler)

from tests.test_torch_scheduler import (CFG, LOGIT_TOL, JScheduler,
                                        _Margins, engines, serve)

torch.set_num_threads(1)

PENALIZED = dict(do_sample=False, repetition_penalty=1.1,
                 frequency_penalty=0.05, presence_penalty=0.02)


def _draws(seed: int, trials: int):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 128, int(rng.integers(8, 90)))]
            for _ in range(trials)]


# Random prompts (vocabulary 128, 8-89 tokens) whose sequential greedy
# margins over 28 tokens exceed 0.3 without penalties, with the repetition
# penalty 1.1 or 1.05, and with PENALIZED (trials of seed 0 searched on
# the CPU; asserted at every pick by HostMargins / _Margins).
SPEC_PROMPTS = [_draws(0, 58)[i] for i in (0, 5, 27, 29, 48, 57)]
SPEC_BUDGETS = [24, 20, 16, 12, 24]
SINGLE = (SPEC_PROMPTS[1], SPEC_PROMPTS[3])
# Two random prompts whose 40-token greedy continuations under the
# repetition penalty 1.05 keep margins above 0.25 and stay random enough
# that speculation backs off (the first two trials of seed 1, searched).
BACKOFF_PROMPTS = _draws(1, 2)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")


def _sp(kw, jax_side=False):
    return (JSP if jax_side else tsmp.SamplingParams)(**kw)


class HostMargins:
    """The top-2 margin of every argmax the port's speculative paths take:
    the host picks (`_PenalizedGreedy.pick`, penalties applied) and the
    verify forward's device argmax (over the real rows: positions below
    max_len - 1)."""

    def __init__(self, monkeypatch):
        self.seen = []
        pick, argmax = tsp._PenalizedGreedy.pick, tsp._verify_forward_argmax

        def pick_(pen, row, extra):
            l = (np.asarray(row, np.float32) if pen.sp is None else
                 tsp._penalized_row(row, pen.sp, pen.obs + extra))
            top2 = np.sort(l)[-2:]
            self.seen.append(float(top2[1] - top2[0]))
            return pick(pen, row, extra)

        def argmax_(params, cfg, cache, ids, pos, kv_lens, comp=None):
            logits, cache = tsp._verify_forward(params, cfg, cache, ids, pos,
                                                kv_lens, comp=comp)
            real = pos < cache.max_len - 1
            if real.any():
                top2 = torch.topk(logits[real], 2, dim=-1).values
                self.seen.append((top2[:, 0] - top2[:, 1]).min().item())
            return torch.argmax(logits, dim=-1).to(torch.int32), cache

        monkeypatch.setattr(tsp._PenalizedGreedy, "pick", pick_)
        monkeypatch.setattr(tsp, "_verify_forward_argmax", argmax_)
        del argmax

    def check(self, tol: float = LOGIT_TOL):
        assert self.seen and min(self.seen) > tol, min(self.seen)


def contiguous(kv_quantized=False, max_batch=2):
    return engines("contiguous", kv_quantized, max_batch)


# ---------------------------------------------------------------------------
# the n-gram proposer
# ---------------------------------------------------------------------------


def test_propose_ngram_matches_jax():
    """The list and numpy forms, on the fixed cases of the JAX test and on
    random contexts with tiny vocabularies (frequent matches), equal JAX's
    and each other."""
    assert tsp.propose_ngram([5, 6, 7, 8, 5, 6, 7], 3) == [8, 5, 6]
    assert tsp.propose_ngram([1, 2, 3, 4], 3) is None
    assert tsp.propose_ngram([1, 9, 2, 9], 2, max_ngram=3) == [2, 9]
    assert tsp.propose_ngram([1], 2) is None
    rng = np.random.default_rng(0)
    for _ in range(80):
        n = int(rng.integers(2, 220))
        ctx = rng.integers(0, int(rng.integers(2, 7)), size=n).tolist()
        for k in (1, 3, 6):
            for mx in (1, 3):
                want = jsp._propose_ngram_list(ctx, k, mx, 1)
                assert tsp._propose_ngram_list(ctx, k, mx, 1) == want
                assert tsp._propose_ngram_np(
                    np.asarray(ctx, np.int32), k, mx, 1) == want
                assert tsp.propose_ngram(ctx, k, mx) == jsp.propose_ngram(
                    ctx, k, mx)


# ---------------------------------------------------------------------------
# the single-sequence greedy helper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("penalized", [False, True],
                         ids=["greedy", "penalized"])
def test_greedy_speculative_matches_jax(kv_quantized, penalized,
                                        monkeypatch):
    """`generate_greedy_speculative`: JAX's ids, and the sequential ones
    (`Engine.generate_greedy`, or the scheduler's penalized greedy)."""
    margins = HostMargins(monkeypatch)
    dev_margins = _Margins(monkeypatch)
    sp = _sp(PENALIZED) if penalized else None
    jsp_ = _sp(PENALIZED, True) if penalized else None
    for prompt in SINGLE:
        je, pe = contiguous(kv_quantized)
        want = jsp.generate_greedy_speculative(je, prompt, 28, k=5, sp=jsp_)
        got = tsp.generate_greedy_speculative(pe, prompt, 28, k=5, sp=sp)
        assert got == want
        _, pe = contiguous(kv_quantized)
        if penalized:
            seq = serve(ContinuousBatchingScheduler(pe, sp, chunk_size=8),
                        [prompt], [28])[0][1]
        else:
            seq = pe.generate_greedy(prompt, 28)
        assert got == seq
        # the slot's lengths were synced at the end
        assert int(pe.cache.lengths[0]) > 0
    margins.check()
    if penalized:
        dev_margins.check()


def test_greedy_speculative_eos_and_budget(monkeypatch):
    """An eos that occurs stops both packages at the same token; a budget
    gives exactly max_new_tokens, the greedy prefix."""
    margins = HostMargins(monkeypatch)
    prompt = SINGLE[0]
    _, pe = contiguous()
    ref = pe.generate_greedy(prompt, 20)
    eos = ref[9]
    je, pe = contiguous()
    want = jsp.generate_greedy_speculative(je, prompt, 20, eos_id=eos, k=5)
    got = tsp.generate_greedy_speculative(pe, prompt, 20, eos_id=eos, k=5)
    assert got == want and got[-1] == eos
    _, pe = contiguous()
    assert got == pe.generate_greedy(prompt, 20, eos_id=eos)
    _, pe = contiguous()
    assert tsp.generate_greedy_speculative(pe, prompt, 7, k=5) == ref[:7]
    margins.check()


def test_paged_engine_refused():
    """The single-sequence helpers own slot 0 of a contiguous cache."""
    _, pe = engines(128, True, 1)
    with pytest.raises(NotImplementedError, match="contiguous"):
        tsp.generate_greedy_speculative(pe, [1, 2, 3], 4)
    with pytest.raises(NotImplementedError, match="contiguous"):
        tsp.generate_sampled_speculative(
            pe, [1, 2, 3], 4, tsmp.SamplingParams(do_sample=True))


# ---------------------------------------------------------------------------
# the scheduler's speculative joint steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["contiguous", 128], ids=["engine",
                                                           "paged128"])
@pytest.mark.parametrize("kv_quantized", [False, True], ids=["bf16", "int8"])
def test_scheduler_speculative_matches_jax(kind, kv_quantized, monkeypatch):
    """Greedy (the scheduler's default, repetition penalty 1.1) deliveries
    and finish order equal to the JAX scheduler's, 5 requests over 2
    slots; the page pool free at the end."""
    margins = HostMargins(monkeypatch)
    dev_margins = _Margins(monkeypatch)
    je, pe = engines(kind, kv_quantized)
    want = serve(JScheduler(je, speculative=True, spec_k=5),
                 SPEC_PROMPTS[:5], SPEC_BUDGETS)
    sched = ContinuousBatchingScheduler(pe, speculative=True, spec_k=5)
    got = serve(sched, SPEC_PROMPTS[:5], SPEC_BUDGETS)
    assert got == want
    assert [len(g) for _, g in sorted(got)] == SPEC_BUDGETS
    assert not sched._dev_lens_dirty or not sched.running
    if kind != "contiguous":
        assert pe._alloc.available == pe.n_pages - 1
    margins.check()
    dev_margins.check()


def test_scheduler_speculative_unpenalized_and_penalized(monkeypatch):
    """Unpenalized greedy (the device argmax of the verify rows) and the
    penalized greedy of the JAX test: JAX's ids and the plain scheduler's
    (paged pool at page size 16, where spec_k and the buckets clamp)."""
    margins = HostMargins(monkeypatch)
    dev_margins = _Margins(monkeypatch)
    for kw, kind in ((dict(do_sample=False, repetition_penalty=1.0),
                      "contiguous"), (PENALIZED, 16)):
        je, pe = engines(kind, True)
        want = serve(JScheduler(je, _sp(kw, True), speculative=True,
                                spec_k=5), SPEC_PROMPTS[:5], SPEC_BUDGETS)
        got = serve(ContinuousBatchingScheduler(pe, _sp(kw),
                                                speculative=True, spec_k=5),
                    SPEC_PROMPTS[:5], SPEC_BUDGETS)
        assert got == want
        _, pe = engines(kind, True)
        plain = serve(ContinuousBatchingScheduler(pe, _sp(kw)),
                      SPEC_PROMPTS[:5], SPEC_BUDGETS)
        assert sorted(got) == sorted(plain)
    margins.check()
    dev_margins.check()


def test_scheduler_speculative_backoff_and_eos(monkeypatch):
    """Random text pushes the gain EMA under 0.35: backoff runs plain
    decode steps (and resyncs the device sampler's penalty state from the
    host replicas); an eos stops slots where the plain scheduler does."""
    margins = HostMargins(monkeypatch)
    dev_margins = _Margins(monkeypatch)
    sp = dict(do_sample=False, repetition_penalty=1.05)
    prompts = BACKOFF_PROMPTS
    _, pe = contiguous()
    ref = serve(ContinuousBatchingScheduler(pe, _sp(sp)), prompts, [40, 40])
    runs = []
    for cls, eng, spx in ((ContinuousBatchingScheduler, contiguous()[1],
                           _sp(sp)),
                          (JScheduler, contiguous()[0], _sp(sp, True))):
        sched = cls(eng, spx, speculative=True, spec_k=5, chunk_size=4)
        backoff = []
        rids = [sched.add_request(p, 40) for p in prompts]
        while sched.has_work:
            sched.step()
            backoff.append(sched._spec_backoff)
        done = {s.request_id: s.generated for s in sched.pop_finished()}
        runs.append(([done[r] for r in rids], backoff))
    assert runs[0][0] == runs[1][0] == [g for _, g in sorted(ref)]
    assert runs[0][1] == runs[1][1] and max(runs[0][1]) > 0
    eos = dict(ref)[0][10]
    je, pe = contiguous()
    want = serve(JScheduler(je, _sp(sp, True), eos_id=eos, speculative=True,
                            spec_k=5), prompts, [40, 40])
    got = serve(ContinuousBatchingScheduler(pe, _sp(sp), eos_id=eos,
                                            speculative=True, spec_k=5),
                prompts, [40, 40])
    assert got == want and dict(got)[0][-1] == eos
    margins.check()
    dev_margins.check()


def test_scheduler_refuses_unreplicable_sampling():
    """Sampled params with a host replica run; tfs / typical / mirostat
    raise, as in the JAX package, for speculative and mixed steps, and
    mixed prefill over chatglm's rope; the paged clamps of spec_k and
    mixed_chunk."""
    _, pe = contiguous()
    ContinuousBatchingScheduler(
        pe, tsmp.SamplingParams(do_sample=True, temperature=0.8),
        speculative=True)
    for bad in (dict(mirostat=2), dict(tfs_z=0.9), dict(typical_p=0.9)):
        for mode in (dict(speculative=True), dict(mixed_prefill=True)):
            with pytest.raises(ValueError, match="tfs/typical/mirostat"):
                ContinuousBatchingScheduler(
                    pe, tsmp.SamplingParams(do_sample=True, **bad), **mode)
    # chatglm's bidirectional prompt cannot be fed in chunks (the JAX guard)
    glm = types.SimpleNamespace(
        cfg=dataclasses.replace(pe.cfg, rope_style="chatglm"), max_batch=2,
        device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="chatglm"):
        ContinuousBatchingScheduler(glm, mixed_prefill=True)
    je, pe = engines(16, True)
    s = ContinuousBatchingScheduler(pe, mixed_prefill=True, mixed_chunk=32,
                                    speculative=True, spec_k=31)
    j = JScheduler(je, mixed_prefill=True, mixed_chunk=32, speculative=True,
                   spec_k=31)
    assert (s.mixed_chunk, s.spec_k, s.spec_min_k) == (
        j.mixed_chunk, j.spec_k, j.spec_min_k) == (16, 15, 3)


# ---------------------------------------------------------------------------
# sampled speculation
# ---------------------------------------------------------------------------


TARGET_SPS = [
    dict(do_sample=True, temperature=0.7, top_k=0, top_p=1.0,
         repetition_penalty=1.0),
    dict(do_sample=True, temperature=1.3, top_k=8, top_p=1.0,
         repetition_penalty=1.0),
    dict(do_sample=True, temperature=0.9, top_k=0, top_p=0.8,
         repetition_penalty=1.0),
    dict(do_sample=True, temperature=0.8, top_k=12, top_p=0.9,
         repetition_penalty=1.15, frequency_penalty=0.1,
         presence_penalty=0.05, penalty_window=8),
]


@pytest.mark.parametrize("kw", TARGET_SPS, ids=range(len(TARGET_SPS)))
def test_target_dist_matches_device_sampler(kw):
    """`_target_dist` (host) against the port's sampling pipeline
    (penalties -> temperature -> top-k -> top-p -> softmax) and against
    JAX's `_target_dist`."""
    rng = np.random.default_rng(7)
    v = 64
    sp = tsmp.SamplingParams(**kw)
    row = rng.normal(size=(v,)).astype(np.float32) * 2.0
    obs = rng.integers(0, v, size=20).tolist()
    st = tsmp.init_state(0, 1, v, window=sp.penalty_window, device="cpu")
    st = tsmp.observe_prompt_slot(st, 0, obs[-sp.penalty_window:])
    # counts cover every observed token, as sequential observation does
    st.counts.copy_(torch.from_numpy(
        np.bincount(obs, minlength=v).astype(np.int32))[None])
    lg = tsmp.apply_penalties(torch.from_numpy(row)[None], st, sp)
    lg = lg / sp.temperature
    lg = tsmp.top_p_filter(tsmp.top_k_filter(lg, sp.top_k), sp.top_p)
    dev = torch.softmax(lg, dim=-1)[0].numpy()
    host = tsp._target_dist(row, sp, obs)
    np.testing.assert_allclose(host, dev, atol=2e-5)
    np.testing.assert_array_equal(
        host, jsp._target_dist(row, JSP(**kw), obs))


def test_sampled_speculative_topk1_equals_greedy(monkeypatch):
    """top_k = 1 makes the target a point mass at the penalized argmax:
    sampled speculation emits the greedy sequence, with budget and eos."""
    margins = HostMargins(monkeypatch)
    prompt = SINGLE[0]
    sp_g = tsmp.SamplingParams(do_sample=False, repetition_penalty=1.1)
    sp_s = tsmp.SamplingParams(do_sample=True, temperature=0.8, top_k=1,
                               top_p=1.0, repetition_penalty=1.1)
    ref = tsp.generate_greedy_speculative(contiguous()[1], prompt, 28, k=5,
                                          sp=sp_g)
    out = tsp.generate_sampled_speculative(contiguous()[1], prompt, 28,
                                           sp_s, k=5, seed=123)
    assert out == ref
    assert tsp.generate_sampled_speculative(contiguous()[1], prompt, 7,
                                            sp_s, k=5) == ref[:7]
    eos = ref[9]
    ref_eos = tsp.generate_greedy_speculative(contiguous()[1], prompt, 28,
                                              k=5, sp=sp_g, eos_id=eos)
    out_eos = tsp.generate_sampled_speculative(contiguous()[1], prompt, 28,
                                               sp_s, k=5, eos_id=eos, seed=5)
    assert out_eos == ref_eos and out_eos[-1] == eos
    margins.check()
    # the scheduler's sampled joint steps: the same point mass
    got = serve(ContinuousBatchingScheduler(contiguous()[1], sp_s,
                                            speculative=True, spec_k=5),
                [prompt], [28])[0][1]
    assert got == ref


class _DrawLog:
    """The host draws of one run of sampled speculation, in order: an
    accept test `rng.random() < p[x]` as ("accept", u, p[x]) (the uniform
    number is a float that logs its comparison), a `choice(n, p=p)` as
    ("choice", u, p), its uniform number read ahead from a copy of the
    generator's state (numpy's Generator inverts the normalized CDF with
    one `random()`: checked at every draw)."""

    def __init__(self):
        self.events = []
        log = self
        make = np.random.default_rng

        class U(float):
            def __lt__(self, other):
                log.events.append(("accept", float(self), float(other)))
                return float(self) < float(other)

        class Rng:
            def __init__(self, seed):
                self.g = make(seed)

            def random(self):
                return U(self.g.random())

            def choice(self, n, p):
                state = self.g.bit_generator.state
                u = self.g.random()
                self.g.bit_generator.state = state
                idx = self.g.choice(n, p=p)
                cdf = np.cumsum(p)
                assert idx == np.searchsorted(cdf / cdf[-1], u, side="right")
                log.events.append(("choice", u, np.asarray(p, np.float64)))
                return idx

        self.rng = Rng


def _sampled_run(monkeypatch, mod, engine, prompt, n, sp, seed):
    log = _DrawLog()
    with monkeypatch.context() as mp:
        mp.setattr(np.random, "default_rng", log.rng)
        out = mod.generate_sampled_speculative(engine, prompt, n, sp, k=5,
                                               seed=seed)
    return out, log.events


def _margins(ours, theirs):
    """Per draw: the uniform number's distance to the decision boundary in
    our run, and how far the other package moves that boundary."""
    res = []
    for (kind, u, a), (kind2, u2, b) in zip(ours, theirs):
        assert kind == kind2 and u == u2
        if kind == "accept":
            res.append((abs(u - a), abs(a - b)))
            continue
        ca, cb = np.cumsum(a) / a.sum(), np.cumsum(b) / b.sum()
        idx = int(np.searchsorted(ca, u, side="right"))
        lo = ca[idx - 1] if idx else 0.0
        res.append((min(u - lo, ca[idx] - u), np.abs(ca - cb).max()))
    return res


# seeds searched on the CPU: every draw clears its boundary by more than
# the other package moves it
SAMPLED_SEEDS = [0, 1, 2]
SAMPLED_SP = dict(do_sample=True, temperature=0.8, top_k=8, top_p=0.95,
                  repetition_penalty=1.1)


@pytest.mark.parametrize("seed", SAMPLED_SEEDS)
def test_sampled_speculative_token_for_token(seed, monkeypatch):
    """Sampled speculation in both packages from the same seed: the same
    tokens, and every draw's uniform number farther from its boundary
    (the accept threshold p[x], or the CDF step of `choice`) than the
    boundary moves between the two packages' distributions."""
    je, pe = contiguous()
    prompt = SINGLE[0]
    got, ours = _sampled_run(monkeypatch, tsp, pe, prompt, 20,
                             tsmp.SamplingParams(**SAMPLED_SP), seed)
    want, theirs = _sampled_run(monkeypatch, jsp, je, prompt, 20,
                                JSP(**SAMPLED_SP), seed)
    assert got == want
    assert len(ours) == len(theirs)
    assert any(kind == "accept" for kind, _, _ in ours)
    for margin, moved in _margins(ours, theirs):
        assert margin > moved, (margin, moved)


def _sequential(engine, prompt, n, sp, seed):
    """Token-by-token sampling from the host replica of the pipeline (the
    target process of sampled speculation)."""
    rng = np.random.default_rng(seed)
    obs = list(prompt[-sp.penalty_window:])
    b = engine.max_batch
    row = engine.prefill([prompt])[0].float().numpy()
    out = []
    while len(out) < n:
        p = tsp._target_dist(row, sp, obs)
        tok = int(rng.choice(p.shape[0], p=p))
        out.append(tok)
        obs.append(tok)
        if len(out) >= n:
            break
        active = torch.zeros((b,), dtype=torch.bool)
        active[0] = True
        row = engine.decode(torch.full((b,), tok, dtype=torch.int32),
                            active)[0].float().numpy()
    return out


def test_sampled_speculative_statistically_exact():
    """Per-position token marginals of sampled speculation (the
    single-sequence helper and the scheduler's joint steps over both
    slots) within 0.15 total variation of sequential sampling, as JAX's
    test."""
    sp = tsmp.SamplingParams(do_sample=True, temperature=0.75, top_k=4,
                             top_p=1.0, repetition_penalty=1.05)
    prompt = list(range(1, 9)) * 4            # repetitive: drafts fire
    n, runs, v = 3, 300, CFG["vocab_size"]
    _, ea = contiguous()
    _, eb = contiguous()
    f_ref, f_spec, f_sched = (np.zeros((n, v)) for _ in range(3))
    for s in range(runs):
        r = _sequential(ea, prompt, n, sp, 10_000 + s)
        o = tsp.generate_sampled_speculative(eb, prompt, n, sp, k=4,
                                             seed=20_000 + s)
        assert len(o) == n
        for j in range(n):
            f_ref[j, r[j]] += 1
            f_spec[j, o[j]] += 1
    for s in range(runs // 2):                # 2 slots per run
        sched = ContinuousBatchingScheduler(eb, sp, seed=50_000 + s,
                                            speculative=True, spec_k=4)
        rids = [sched.add_request(list(prompt), n) for _ in range(2)]
        done = {q.request_id: q.generated for q in sched.run_to_completion()}
        for rid in rids:
            for j in range(n):
                f_sched[j, done[rid][j]] += 1
    for f in (f_spec, f_sched):
        tv = 0.5 * np.abs(f_ref / runs - f / runs).sum(axis=1)
        assert (tv < 0.15).all(), tv


def test_sampled_speculative_refusals():
    _, pe = contiguous()
    for bad in (dict(do_sample=False), dict(do_sample=True, mirostat=2),
                dict(do_sample=True, tfs_z=0.9),
                dict(do_sample=True, typical_p=0.9)):
        with pytest.raises(ValueError):
            tsp.generate_sampled_speculative(
                pe, [1, 2], 4, tsmp.SamplingParams(**bad))


# ---------------------------------------------------------------------------
# api.Model.generate(speculative=True)
# ---------------------------------------------------------------------------


def _models(kind):
    je, pe = engines(kind, True)
    jm, tm = japi.Model(), api.Model()
    for m, e in ((jm, je), (tm, pe)):
        m.cfg, m.engine, m.eos_id = e.cfg, e, None
    return jm, tm


@pytest.mark.parametrize("kind", ["contiguous", 128], ids=["engine",
                                                           "paged128"])
def test_api_speculative_routing(kind, monkeypatch):
    """One prompt over a contiguous engine runs the single-sequence helper,
    a batch (and any paged engine) the scheduler's joint steps; greedy ids
    (repetition penalty 1.1, generate's default) equal the JAX Model's and
    the plain generate's."""
    margins = HostMargins(monkeypatch)
    calls = []
    helper = tsp.generate_greedy_speculative

    def spy(*a, **kw):
        calls.append("helper")
        return helper(*a, **kw)

    monkeypatch.setattr(tsp, "generate_greedy_speculative", spy)
    joint = ContinuousBatchingScheduler._joint_step

    def joint_spy(self, include_prefill):
        calls.append("joint")
        return joint(self, include_prefill)

    monkeypatch.setattr(ContinuousBatchingScheduler, "_joint_step",
                        joint_spy)
    for prompts in ([SINGLE[0]], SPEC_PROMPTS[:3]):
        calls.clear()
        jm, tm = _models(kind)
        kw = dict(max_new_tokens=16, speculative=True, speculative_k=5,
                  ignore_prompt=True)
        want = jm.generate(prompts, **kw)
        got = tm.generate(prompts, **kw)
        assert got == want
        single = len(prompts) == 1 and kind == "contiguous"
        assert ("helper" in calls) == single
        assert ("joint" in calls) == (not single)
        _, tm = _models(kind)
        assert tm.generate(prompts, max_new_tokens=16,
                           ignore_prompt=True) == got
    with pytest.raises(ValueError, match="stopping_criteria"):
        tm.generate(SINGLE[:1], speculative=True,
                    stopping_criteria=lambda ids: False)
    margins.check()


def test_api_batched_sampled_speculation(monkeypatch):
    """generate(speculative=True, do_sample=True) over several prompts
    runs the scheduler to the budget, every token inside its step's
    target support (teacher-forced replay, as JAX's test)."""
    _, tm = _models("contiguous")
    kw = dict(do_sample=True, temperature=0.9, top_k=8, top_p=0.9,
              repetition_penalty=1.1)
    prompts = [SPEC_PROMPTS[0], SPEC_PROMPTS[3]]
    out = tm.generate(prompts, max_new_tokens=12, seed=3, speculative=True,
                      ignore_prompt=True, **kw)
    sp = tsmp.SamplingParams(**kw)
    for p, o in zip(prompts, out):
        assert len(o) == 12
        _, eng = contiguous()
        obs = list(p[-sp.penalty_window:])
        row = eng.prefill([p])[0].float().numpy()
        for i, tok in enumerate(o):
            assert tsp._target_dist(row, sp, obs)[tok] > 0.0
            obs.append(tok)
            active = torch.zeros((2,), dtype=torch.bool)
            active[0] = True
            row = eng.decode(torch.full((2,), tok, dtype=torch.int32),
                             active)[0].float().numpy()
