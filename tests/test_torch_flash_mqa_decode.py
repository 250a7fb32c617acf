"""The decode route of the calls kernel B cannot take (more than 8 query
heads per KV head, or an odd KV head count): the port sends them to the
rows decode body (`csrc/flash_rows.cuh`, counted `flash_rows...`), whose
function and plain version are kernel C's at T = 1.

* `mha` / `mha_paged` at t = 1 against the JAX entries with
  NST_FLASH=interpret (the Pallas bodies) at Falcon-7B's 71 query heads over
  one KV head (D = 64), Gemma-2B's 8 over one (D = 256) and 12 over 3
  (D = 128), over int8 K/V with bf16 and float32 scales, bf16 and float32
  K/V; ALiBi, the logit softcap and non-causal once each.  Three slots: one
  live at kv_len - 1, one a spectator parked at S - 1, one idle (kv_len 0,
  whose rows are 0).  Tolerance: 2 bf16 ulps of the largest output, as
  `test_torch_flash_variants.py` (both sides round q and P times the V
  scale to bf16 at the same points; only the order of the float32 sums and
  the output rounding differ).  The paged plain version must equal the
  contiguous one over the gathered layer bit for bit.
* `decode_body` names the body of each call: the rows body, B / 10, or C / 9
  (prefill, and int8 decode after a plain append that B could take).
* `rows_chunking`: whole 32-column tiles, enough chunks for two waves of
  the SMs where the columns allow, covering the cache.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.ops import flash as jfl
from neural_speed_tpu.ops import paged_kv as jpk
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch.ops import attention as tat
from neural_speed_tpu_torch.ops import flash as tfl
from neural_speed_tpu_torch.ops import paged_kv as tpk

from tests.torch_port_util import (bf16_to_f32, jax_bf16, to_numpy,
                                   torch_bf16, torch_to_numpy)

torch.set_num_threads(1)
ULP = 2.0 ** -8
L, B, S, PS = 2, 3, 256, 128
HEADS = [(71, 1, 64), (8, 1, 256), (12, 3, 128)]
KVS = ["int8", "int8f32", "bf16", "f32"]
SUFFIX = {"int8": "", "int8f32": "_f32scale", "bf16": "_bf16", "f32": "_f32"}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")


def _t(a):
    """A JAX array as the port's tensor with the same bits."""
    if a.dtype == jnp.bfloat16:
        return torch_bf16(a)
    return torch.from_numpy(np.asarray(a).copy())


def _close(got_t, want_j, ulps=2):
    got = bf16_to_f32(torch_to_numpy(got_t))
    want = bf16_to_f32(to_numpy(want_j))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ulps * ULP * np.abs(want).max())


def _rows(rng, shape, kv):
    if kv.startswith("int8"):
        return jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
    x = rng.standard_normal(shape).astype(np.float32)
    return jax_bf16(x) if kv == "bf16" else jnp.asarray(x)


def _scales(rng, shape, kv):
    if not kv.startswith("int8"):
        return None
    s = rng.uniform(0.5, 1.5, shape).astype(np.float32) * 0.02
    return jnp.asarray(s) if kv == "int8f32" else jax_bf16(s)


def _step(h, d, rng, q_std):
    """One decode step: slot 0 live at kv_len - 1, slot 1 a spectator
    parked at S - 1, slot 2 idle (no column)."""
    kv_lens = np.array([150, 77, 0], np.int32)
    pos = np.array([[149], [S - 1], [S - 1]], np.int32)
    q = jax_bf16((rng.standard_normal((B, 1, h, d)) * q_std).astype(
        np.float32))
    return q, pos, kv_lens


def _kw(alibi, softcap, causal, h):
    jkw = dict(causal=causal, logit_softcap=softcap)
    tkw = dict(causal=causal, logit_softcap=softcap)
    if alibi:
        jkw["alibi"] = jnp.asarray(tat.alibi_slopes(h).numpy())
        tkw["alibi"] = tat.alibi_slopes(h)
    return jkw, tkw


def _counter(name, kv, softcap, causal):
    return (name + SUFFIX[kv] + ("_softcap" if softcap else "")
            + ("" if causal else "_noncausal"))


def _contiguous(kv, h, hkv, d, rng, alibi=False, softcap=0.0, causal=True,
                q_std=1.0):
    kc = _rows(rng, (L, B, hkv, S, d), kv)
    vc = _rows(rng, (L, B, hkv, S, d), kv)
    ks, vs = (_scales(rng, (L, B, hkv, S), kv) for _ in range(2))
    q, pos, kv_lens = _step(h, d, rng, q_std)
    jkw, tkw = _kw(alibi, softcap, causal, h)
    scale = 1.0 / math.sqrt(d)
    out_j = jfl.mha(q, kc, vc, ks, vs, jnp.asarray(pos),
                    jnp.asarray(kv_lens), scale=scale, layer=1, **jkw)
    name = _counter("flash_rows", kv, softcap, causal)
    before = _build.plain_dispatches[name]
    out_t = tfl.mha(torch_bf16(q), *(None if a is None else _t(a)
                                     for a in (kc, vc, ks, vs)),
                    torch.from_numpy(pos), torch.from_numpy(kv_lens),
                    scale=scale, layer=1, **tkw)
    assert _build.plain_dispatches[name] == before + 1, name
    return out_t, out_j


def _paged(kv, h, hkv, d, rng, alibi=False, softcap=0.0, causal=True,
           q_std=1.0):
    nb = S // PS
    n_pages = B * nb + 1
    kc = _rows(rng, (L, hkv, n_pages, PS, d), kv)
    vc = _rows(rng, (L, hkv, n_pages, PS, d), kv)
    ks, vs = (_scales(rng, (L, hkv, n_pages, 1, PS), kv) for _ in range(2))
    tables = rng.permutation(n_pages - 1).reshape(B, nb).astype(np.int32)
    lens = np.zeros((B,), np.int32)
    jc = jpk.PagedKVCache(kc, vc, ks, vs, jnp.asarray(tables),
                          jnp.asarray(lens))
    tc = tpk.PagedKVCache(*(None if a is None else _t(a)
                            for a in (kc, vc, ks, vs)),
                          torch.from_numpy(tables), torch.from_numpy(lens))
    q, pos, kv_lens = _step(h, d, rng, q_std)
    jkw, tkw = _kw(alibi, softcap, causal, h)
    scale = 1.0 / math.sqrt(d)
    out_j = jfl.mha_paged(q, jc, 1, jnp.asarray(pos), jnp.asarray(kv_lens),
                          scale=scale, **jkw)
    name = _counter("flash_rows_paged", kv, softcap, causal)
    before = _build.plain_dispatches[name]
    args_t = (torch_bf16(q), tc, 1, torch.from_numpy(pos),
              torch.from_numpy(kv_lens))
    out_t = tfl.mha_paged(*args_t, scale=scale, **tkw)
    assert _build.plain_dispatches[name] == before + 1, name
    rows = [None if a is None else a[None] for a in
            tpk.gather_layer_codes(tc.k_pages, tc.v_pages, tc.k_scale,
                                   tc.v_scale, tc.page_tables, 1)]
    assert torch.equal(out_t, tfl.mha(args_t[0], *rows, args_t[3],
                                      args_t[4], scale=scale, layer=0,
                                      **tkw))
    return out_t, out_j


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("h,hkv,d", HEADS, ids=["falcon", "gemma", "odd"])
def test_rows_route_matches_pallas(h, hkv, d, kv, paged):
    rng = np.random.default_rng(h * 7 + d + KVS.index(kv) * 3 + paged)
    run = _paged if paged else _contiguous
    out_t, out_j = run(kv, h, hkv, d, rng)
    assert out_j is not None and out_t.shape == (B, 1, h, d)
    assert not out_t[2].float().abs().any()      # the idle slot
    _close(out_t, out_j)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("variant", ["alibi", "softcap", "noncausal"])
def test_rows_route_variants(variant, paged):
    """ALiBi (71 heads: the non-power-of-two slopes), grok's softcap over
    int8 K/V with q scaled so that it bites, and non-causal (whisper's
    cross attention, where the spectator's parked position does not
    mask)."""
    h, hkv, d = (71, 1, 64) if variant != "softcap" else (12, 3, 128)
    kw = dict(alibi=variant == "alibi",
              softcap=2.0 if variant == "softcap" else 0.0,
              causal=variant != "noncausal",
              q_std=8.0 if variant == "softcap" else 1.0)
    rng = np.random.default_rng(["alibi", "softcap", "noncausal"].index(
        variant) * 5 + paged)
    run = _paged if paged else _contiguous
    out_t, out_j = run("int8" if variant == "softcap" else "bf16", h, hkv, d,
                       rng, **kw)
    assert out_j is not None
    _close(out_t, out_j)


ROUTES = [
    # (t, H, Hkv, D, extra, qk, quantized) -> body
    ((1, 71, 1, 64, False, False, False), "rows"),      # Falcon-7B, bf16
    ((1, 71, 1, 64, False, False, True), "rows"),       # ... int8
    ((1, 8, 1, 256, False, False, False), "rows"),      # Gemma-2B
    ((1, 12, 3, 128, False, False, True), "rows"),      # odd KV heads
    ((1, 32, 2, 128, False, False, False), "rows"),     # n_rep 16
    ((1, 128, 1, 128, False, False, False), "rows"),    # n_rep 128
    ((1, 129, 1, 128, False, False, False), "C"),       # past ROWS_MAX_REP
    ((1, 64, 1, 256, False, False, False), "rows"),     # 256's limit
    ((1, 65, 1, 256, False, False, False), "C"),
    ((1, 32, 32, 128, False, False, False), "B"),       # Llama, bf16
    ((1, 32, 8, 128, False, False, False), "B"),
    ((1, 32, 32, 128, True, False, True), "B"),         # the extra column
    ((1, 32, 32, 128, False, True, True), "B"),         # the int8 dot
    ((1, 32, 32, 128, False, False, True), "C"),        # int8 after append
    ((4, 32, 32, 128, False, True, True), "B"),         # verify, int8 dot
    ((2048, 71, 1, 64, False, False, False), "C"),      # prefill
    ((4, 8, 1, 256, False, False, False), "C"),
    ((4, 32, 32, 128, False, False, False), "C"),
]


@pytest.mark.parametrize("call,body", ROUTES,
                         ids=[f"t{c[0]}-h{c[1]}-kv{c[2]}-d{c[3]}"
                              f"{'-extra' if c[4] else ''}"
                              f"{'-qk' if c[5] else ''}"
                              f"{'-int8' if c[6] else ''}"
                              for c, _ in ROUTES])
def test_decode_body(call, body):
    t, h, hkv, d, extra, qk, quantized = call
    assert tfl.decode_body(t, h, hkv, d, extra=extra, qk=qk,
                           quantized=quantized) == body


@pytest.mark.parametrize("b,hkv,s,n_sm,want", [
    (4, 1, 2048, 132, (32, 64)),      # Gemma-2B / Falcon-7B at B = 4
    (1, 1, 2048, 132, (32, 64)),      # fewer tiles than two waves
    (32, 1, 2048, 132, (224, 10)),    # 9 chunks asked for
    (4, 3, 2048, 132, (64, 32)),      # 22 asked for
    (2, 1, 100, 132, (32, 4)),        # a ragged last tile
])
def test_rows_chunking(b, hkv, s, n_sm, want):
    chunk, nch = tfl.rows_chunking(b, hkv, s, n_sm)
    assert (chunk, nch) == want
    assert chunk % tfl.ROWS_TILE == 0 and chunk * nch >= s
    assert b * hkv * nch >= min(tfl.ROWS_WAVES * n_sm,
                                b * hkv * -(-s // tfl.ROWS_TILE))
