"""The port's sampler (`ops/sampling.py`, on the CPU) against the JAX
package's.

* State updates (`observe`, `observe_prompt_slot`, `reset_slot`) and
  `apply_penalties`: exact.
* The filters (top-k, top-p, tail-free, typical) and the logits each
  sampling mode hands to its categorical draw (the default pipeline,
  mirostat v1 and v2): exact.  The filters sum softmax probabilities and
  cumulative sums in another order than XLA, which moves a sum by float32
  ulps; the inputs are drawn so that no kept/dropped decision sits within
  such a step of its threshold, so equality is the check.
* Mirostat's mu update: within 4 float32 ulps (log-softmax and the division
  by ln 2 round in another order).
* Greedy and top_k = 1: identical tokens.
* Sampled tokens: in distribution only (torch and JAX generators differ):
  20000 seeded draws against softmax(filtered logits), chi-square p > 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from neural_speed_tpu.ops import sampling as jsmp
from neural_speed_tpu_torch.ops import sampling as tsmp

torch.set_num_threads(1)
B, V, W = 4, 64, 16


def _states(seed=0, with_history=True):
    rng = np.random.default_rng(seed)
    counts = np.zeros((B, V), np.int32)
    last = np.full((B, W), -1, np.int32)
    ring = np.zeros((B,), np.int32)
    if with_history:
        counts = rng.integers(0, 3, (B, V)).astype(np.int32)
        last = rng.integers(-1, V, (B, W)).astype(np.int32)
        ring = rng.integers(0, 40, (B,)).astype(np.int32)
    mu = rng.uniform(6.0, 12.0, (B,)).astype(np.float32)
    js = jsmp.SamplerState(jax.random.PRNGKey(seed), jnp.asarray(counts),
                           jnp.asarray(last), jnp.asarray(ring),
                           jnp.asarray(mu))
    ts = tsmp.init_state(seed, B, V, window=W, device="cpu")
    ts = dataclasses.replace(ts, counts=torch.from_numpy(counts.copy()),
                             last_tokens=torch.from_numpy(last.copy()),
                             ring_pos=torch.from_numpy(ring.copy()),
                             mu=torch.from_numpy(mu.copy()))
    return js, ts


def _logits(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, V)) * 3.0).astype(np.float32)


def _assert_state_equal(ts, js):
    for name in ("counts", "last_tokens", "ring_pos", "mu"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)


def _sp(**kw):
    return (jsmp.SamplingParams(penalty_window=W, **kw),
            tsmp.SamplingParams(penalty_window=W, **kw))


def test_state_updates_match_jax():
    js, ts = _states(1, with_history=False)
    _assert_state_equal(ts, js)
    prompt = [3, 5, 5, 63, 0, 17, 3, 3, 9, 12, 40, 41, 42, 43, 44, 45, 46,
              47, 48, 3]                       # longer than the ring
    js = jsmp.observe_prompt_slot(js, 1, prompt)
    ts = tsmp.observe_prompt_slot(ts, 1, prompt)
    js = jsmp.observe_prompt_slot(js, 2, prompt[:5])
    ts = tsmp.observe_prompt_slot(ts, 2, prompt[:5])
    _assert_state_equal(ts, js)
    toks = np.array([1, 2, 3, 63], np.int32)
    for active in (None, np.array([True, False, True, True])):
        js = jsmp.observe(js, jnp.asarray(toks),
                          None if active is None else jnp.asarray(active))
        ts = tsmp.observe(ts, torch.from_numpy(toks),
                          None if active is None else torch.from_numpy(active))
        _assert_state_equal(ts, js)
    js = jsmp.reset_slot(js, 1, 3.0)
    ts = tsmp.reset_slot(ts, 1, 3.0)
    _assert_state_equal(ts, js)


def test_penalties_match_jax():
    js, ts = _states(2)
    x = _logits(2)
    for kw in (dict(repetition_penalty=1.3),
               dict(repetition_penalty=1.0, frequency_penalty=0.2,
                    presence_penalty=0.5),
               dict(repetition_penalty=1.1, frequency_penalty=0.3,
                    presence_penalty=0.1)):
        jp, tp = _sp(**kw)
        want = np.asarray(jsmp.apply_penalties(jnp.asarray(x), js, jp))
        got = tsmp.apply_penalties(torch.from_numpy(x), ts, tp).numpy()
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, x)


@pytest.mark.parametrize("name,arg", [("top_k_filter", 7),
                                      ("top_p_filter", 0.8),
                                      ("tail_free_filter", 0.9),
                                      ("typical_filter", 0.7)])
def test_filters_match_jax(name, arg):
    for seed in range(3):
        x = _logits(10 + seed)
        want = np.asarray(getattr(jsmp, name)(jnp.asarray(x), arg))
        got = getattr(tsmp, name)(torch.from_numpy(x), arg).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got == jsmp.NEG_INF).any() and (got != jsmp.NEG_INF).any()


@pytest.fixture
def captured(monkeypatch):
    """Replace both categorical draws by argmax and record the logits each
    pipeline hands to it."""
    seen = {"jax": [], "torch": []}

    def jax_cat(key, logits, axis=-1):
        seen["jax"].append(np.asarray(logits))
        return jnp.argmax(logits, axis=axis)

    def torch_cat(logits, generator):
        seen["torch"].append(logits.numpy().copy())
        return torch.argmax(logits, dim=-1).to(torch.int32)

    monkeypatch.setattr(jax.random, "categorical", jax_cat)
    monkeypatch.setattr(tsmp, "categorical", torch_cat)
    return seen


@pytest.mark.parametrize("kw", [
    dict(),                                    # the defaults
    dict(top_k=0, top_p=1.0, tfs_z=0.9, typical_p=0.8, temperature=0.7),
    dict(mirostat=1, mirostat_tau=3.0),
    dict(mirostat=2, mirostat_tau=3.0),
], ids=["default", "tfs_typical", "mirostat1", "mirostat2"])
def test_sample_pipeline_matches_jax(kw, captured):
    js, ts = _states(3)
    x = _logits(3)
    active = np.array([True, True, False, True])
    jp, tp = _sp(**kw)
    jt, js2 = jsmp.sample(jnp.asarray(x), js, jp, active=jnp.asarray(active))
    tt, ts2 = tsmp.sample(torch.from_numpy(x), ts, tp,
                          active=torch.from_numpy(active))
    (jf,), (tf,) = captured["jax"], captured["torch"]
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for name in ("counts", "last_tokens", "ring_pos"):
        np.testing.assert_array_equal(getattr(ts2, name).numpy(),
                                      np.asarray(getattr(js2, name)))
    mu_t, mu_j = ts2.mu.numpy(), np.asarray(js2.mu)
    np.testing.assert_allclose(mu_t, mu_j, rtol=4 * 2.0 ** -23, atol=0)
    if kw.get("mirostat"):
        # the inactive row keeps its mu; the others moved
        assert mu_t[2] == ts.mu[2] and (mu_t[[0, 1, 3]] != ts.mu.numpy()[
            [0, 1, 3]]).all()
        # mirostat v1 keeps a per-row number of tokens: the rows' k
        assert ((tf != jsmp.NEG_INF).sum(-1) < V).any()


def test_greedy_and_top1_match_jax():
    js, ts = _states(4)
    x = _logits(4)
    for kw in (dict(do_sample=False), dict(temperature=0.0),
               dict(top_k=1, temperature=1.3)):
        jp, tp = _sp(**kw)
        jt, _ = jsmp.sample(jnp.asarray(x), js, jp)
        tt, _ = tsmp.sample(torch.from_numpy(x), ts, tp)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tsmp.greedy(torch.from_numpy(x)).dtype == torch.int32


def test_sampled_tokens_follow_the_filtered_distribution():
    """20000 rows of one logit vector through the default pipeline (no
    history, so no penalty): token counts against softmax of the logits
    the JAX pipeline filters (temperature 0.8, top-k 40, top-p 0.95)."""
    n, v = 20000, 48
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((v,)) * 1.5).astype(np.float32)
    jp, tp = _sp()
    filt = jnp.asarray(x[None]) / jp.temperature
    filt = jsmp.top_p_filter(jsmp.top_k_filter(filt, jp.top_k), jp.top_p)
    probs = np.asarray(jax.nn.softmax(filt, axis=-1))[0].astype(np.float64)
    kept = probs > 0
    assert 10 < kept.sum() < v
    st = tsmp.init_state(123, n, v, window=W, device="cpu")
    toks, _ = tsmp.sample(torch.from_numpy(np.tile(x, (n, 1))), st, tp)
    counts = np.bincount(toks.numpy(), minlength=v)
    assert counts[~kept].sum() == 0
    expected = probs[kept] / probs[kept].sum() * n
    p = scipy.stats.chisquare(counts[kept], expected).pvalue
    assert p > 1e-3, p
