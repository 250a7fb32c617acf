"""Grok's logit softcap in the attention kernels' plain versions, against
the JAX package's Pallas bodies (NST_FLASH=interpret) on the CPU.

`mha` / `mha_paged` with `logit_softcap=30` run the port's plain versions
of kernels B, C, 9 and 10 (CPU tensors) and the JAX entries the Pallas
kernels `_mha_kernel_hblk` / `_mha_kernel` in interpret mode, on the same
inputs: decode with the current token as the extra column (softcapped as
the seed of the online softmax) and the fused append, decode after a
plain append (bf16 and float32 K/V), and prefill, over int8 K/V with bf16
and with float32 scales, bf16 and float32 K/V, at n_rep 6 (Grok-1's 48
query heads over 8 KV heads, cut to 12 over 2) and one ALiBi case.

q is drawn so that the scores' spread is 0.7 x the cap: the largest
|score| of a row reaches 2-3x the cap, where `30 * tanh(s / 30)` differs
from s (at the unit-variance inputs of the other attention tests it does
not: |s| stays far below 30).  Held: the outputs within 2 bf16 ulps of the
largest output (as `test_torch_flash_variants.py`: both sides round q and
P (times the V scale) to bf16 at the same points; the f32 summation order,
the online-softmax rescale across blocks and the bf16 output rounding
differ), the fused append's rows equal to JAX's `append_layer` /
`append_decode` byte for byte, and, so that a version that dropped the
softcap fails, the outputs without the softcap more than 10 of those
tolerances away.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.ops import attention as jat
from neural_speed_tpu.ops import flash as jfl
from neural_speed_tpu.ops import kv_cache as jkv
from neural_speed_tpu.ops import paged_kv as jpk
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch.ops import flash as tfl
from neural_speed_tpu_torch.ops import paged_kv as tpk

from tests.torch_port_util import (bf16_to_f32, jax_bf16, to_numpy,
                                   torch_bf16, torch_to_numpy)

torch.set_num_threads(1)
ULP = 2.0 ** -8
ULPS = 2
CAP = 30.0
L, B, S, PS = 2, 2, 256, 128
H, HKV, D = 12, 2, 16
KV_TYPES = ["int8", "int8 f32 scales", "bf16", "f32"]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")


def _t(a):
    """A JAX array as the port's tensor with the same bits."""
    if a.dtype == jnp.bfloat16:
        return torch_bf16(a)
    return torch.from_numpy(np.array(a))


def _tol(want_j) -> float:
    return ULPS * ULP * np.abs(bf16_to_f32(to_numpy(want_j))).max()


def _f32(t: torch.Tensor) -> np.ndarray:
    return bf16_to_f32(torch_to_numpy(t))


def _rows(rng, shape, kv):
    """K/V rows of the cache type, and the standard deviation of the values
    they hold (codes times a ~0.02 scale for int8)."""
    if kv.startswith("int8"):
        return jnp.asarray(rng.integers(-127, 128, shape), jnp.int8), 1.47
    x = rng.standard_normal(shape).astype(np.float32)
    return (jax_bf16(x) if kv == "bf16" else jnp.asarray(x)), 1.0


def _scales(rng, shape, kv):
    if not kv.startswith("int8"):
        return None
    x = rng.uniform(0.5, 1.5, shape).astype(np.float32) * 0.02
    return jnp.asarray(x) if kv.endswith("scales") else jax_bf16(x)


def _case(kind, rng, kstd):
    """q with scores of spread 0.7 x CAP, positions and lengths: decode
    with slot 0 live (the new token at kv_len - 1) and slot 1 a spectator
    parked at S - 1; prefill of 24 rows with slot 0's 20 real rows then
    padding, slot 1 a chunk at offset 90."""
    if kind == "decode":
        kv_lens = np.array([150, 77], np.int32)
        pos = np.array([[149], [S - 1]], np.int32)
    else:
        t = 24
        ar = np.arange(t)
        kv_lens = np.array([20, 90 + t], np.int32)
        pos = np.stack([np.where(ar < 20, ar, S - 1), 90 + ar]).astype(
            np.int32)
    t = pos.shape[1]
    sigma = 0.7 * CAP / kstd          # scale = 1 / sqrt(D)
    q = jax_bf16(sigma * rng.standard_normal((B, t, H, D)).astype(
        np.float32))
    return q, pos, kv_lens


def _sensitive(out_t, uncapped_t, want_j):
    """The softcap bites: the output without it lies more than 10
    tolerances away."""
    off = np.abs(_f32(out_t) - _f32(uncapped_t)).max()
    assert off > 10 * _tol(want_j), (off, _tol(want_j))


CASES = [(kind, kv, False) for kind in ("decode", "prefill")
         for kv in KV_TYPES] + [("decode", "int8", True),
                                ("prefill", "bf16", True)]


@pytest.mark.parametrize("kind,kv,alibi", CASES, ids=lambda v: str(v))
def test_contiguous_softcap_matches_pallas(kind, kv, alibi):
    """`mha` over the stacked cache with the softcap: the int8 decode
    through the extra column and the fused append, the other decodes
    after a plain append (kernel B's bf16 / float32 instances), prefill
    through kernel C's plain version."""
    rng = np.random.default_rng(KV_TYPES.index(kv) * 2 + (kind == "decode")
                                + 10 * alibi)
    kc, kstd = _rows(rng, (L, B, HKV, S, D), kv)
    vc, _ = _rows(rng, (L, B, HKV, S, D), kv)
    ks, vs = (_scales(rng, (L, B, HKV, S), kv) for _ in range(2))
    q, pos, kv_lens = _case(kind, rng, kstd)
    slopes = jat.alibi_slopes(H) if alibi else None
    ta = None if slopes is None else torch.from_numpy(np.array(slopes))
    layer = 1
    kw = dict(scale=1.0 / math.sqrt(D), layer=layer)
    tk, tv, tks, tvs = (None if a is None else _t(a) for a in (kc, vc, ks,
                                                               vs))
    args_t = lambda: (torch_bf16(q), tk.clone(), tv.clone(),
                      None if tks is None else tks.clone(),
                      None if tvs is None else tvs.clone(),
                      torch.from_numpy(pos), torch.from_numpy(kv_lens))
    fused = kind == "decode" and kv.startswith("int8")
    if fused:
        kn, vn = (jax_bf16(rng.standard_normal((B, 1, HKV, D)).astype(
            np.float32)) for _ in range(2))
        extra_t = dict(extra_kv=(torch_bf16(kn), torch_bf16(vn)),
                       fused_append=True)
        out_j, _ = jfl.mha(q, kc, vc, ks, vs, jnp.asarray(pos),
                           jnp.asarray(kv_lens), alibi=slopes,
                           logit_softcap=CAP, extra_kv=(kn, vn),
                           fused_append=True, **kw)
        out_t, cache_t = tfl.mha(*args_t(), alibi=ta, logit_softcap=CAP,
                                 **extra_t, **kw)
        uncapped, _ = tfl.mha(*args_t(), alibi=ta, **extra_t, **kw)
        live = pos[:, 0] == kv_lens - 1
        want = jkv.append_layer(
            jkv.KVCache(kc, vc, ks, vs, jnp.zeros((B,), jnp.int32)), layer,
            kn, vn, jnp.asarray(np.maximum(kv_lens - 1, 0)[:, None]),
            jnp.asarray(live))
        for got, name in zip(cache_t, ("k", "v", "k_scale", "v_scale")):
            np.testing.assert_array_equal(torch_to_numpy(got),
                                          to_numpy(getattr(want, name)))
        assert cache_t[2].dtype == (torch.float32 if kv.endswith("scales")
                                    else torch.bfloat16)
    else:
        out_j = jfl.mha(q, kc, vc, ks, vs, jnp.asarray(pos),
                        jnp.asarray(kv_lens), alibi=slopes,
                        logit_softcap=CAP, **kw)
        route = "flash_decode" if kind == "decode" else "flash_prefill"
        name = route + tfl._kv_suffix(tk, tv, tks, tvs) + "_softcap"
        before = _build.plain_dispatches[name]
        out_t = tfl.mha(*args_t(), alibi=ta, logit_softcap=CAP, **kw)
        assert _build.plain_dispatches[name] == before + 1
        uncapped = tfl.mha(*args_t(), alibi=ta, **kw)
    assert out_j is not None
    np.testing.assert_allclose(_f32(out_t), bf16_to_f32(to_numpy(out_j)),
                               rtol=0, atol=_tol(out_j))
    _sensitive(out_t, uncapped, out_j)


def _pools(rng, kv):
    """A JAX pool and the port's with the same bytes; a shuffled table over
    every page but the trash page."""
    nb = S // PS
    n_pages = B * nb + 1
    kc, kstd = _rows(rng, (L, HKV, n_pages, PS, D), kv)
    vc, _ = _rows(rng, (L, HKV, n_pages, PS, D), kv)
    ks, vs = (_scales(rng, (L, HKV, n_pages, 1, PS), kv) for _ in range(2))
    tables = rng.permutation(n_pages - 1).reshape(B, nb).astype(np.int32)
    lens = np.zeros((B,), np.int32)
    jc = jpk.PagedKVCache(kc, vc, ks, vs, jnp.asarray(tables),
                          jnp.asarray(lens))
    tc = lambda: tpk.PagedKVCache(
        *(None if a is None else _t(a) for a in (kc, vc, ks, vs)),
        torch.from_numpy(tables), torch.from_numpy(lens))
    return jc, tc, kstd


@pytest.mark.parametrize("kind,kv,alibi", CASES, ids=lambda v: str(v))
def test_paged_softcap_matches_pallas(kind, kv, alibi):
    """`mha_paged` (page size 128) with the softcap, as the contiguous
    cases; the paged plain versions equal the contiguous ones over the
    gathered layer bit for bit."""
    rng = np.random.default_rng(40 + KV_TYPES.index(kv) * 2
                                + (kind == "decode") + 10 * alibi)
    jc, tc, kstd = _pools(rng, kv)
    q, pos, kv_lens = _case(kind, rng, kstd)
    slopes = jat.alibi_slopes(H) if alibi else None
    ta = None if slopes is None else torch.from_numpy(np.array(slopes))
    scale, layer = 1.0 / math.sqrt(D), 1
    args_j = (q, jc, layer, jnp.asarray(pos), jnp.asarray(kv_lens))
    args_t = lambda pool: (torch_bf16(q), pool, layer, torch.from_numpy(pos),
                           torch.from_numpy(kv_lens))
    fused = kind == "decode" and kv.startswith("int8")
    if fused:
        kn, vn = (jax_bf16(rng.standard_normal((B, 1, HKV, D)).astype(
            np.float32)) for _ in range(2))
        extra_t = dict(extra_kv=(torch_bf16(kn), torch_bf16(vn)),
                       fused_append=True)
        out_j, _ = jfl.mha_paged(*args_j, scale=scale, alibi=slopes,
                                 logit_softcap=CAP, extra_kv=(kn, vn),
                                 fused_append=True)
        pool_t = tc()
        out_t, _ = tfl.mha_paged(*args_t(pool_t), scale=scale, alibi=ta,
                                 logit_softcap=CAP, **extra_t)
        uncapped, _ = tfl.mha_paged(*args_t(tc()), scale=scale, alibi=ta,
                                    **extra_t)
        live = pos[:, 0] == kv_lens - 1
        want = jpk.append_decode(
            jc, layer, kn, vn,
            jnp.asarray(np.maximum(kv_lens - 1, 0)[:, None]),
            active=jnp.asarray(live))
        n = pool_t.n_pages - 1
        for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
            np.testing.assert_array_equal(
                torch_to_numpy(getattr(pool_t, name))[:, :, :n],
                to_numpy(getattr(want, name))[:, :, :n])
    else:
        out_j = jfl.mha_paged(*args_j, scale=scale, alibi=slopes,
                              logit_softcap=CAP)
        pool_t = tc()
        out_t = tfl.mha_paged(*args_t(pool_t), scale=scale, alibi=ta,
                              logit_softcap=CAP)
        uncapped = tfl.mha_paged(*args_t(tc()), scale=scale, alibi=ta)
        rows = [None if a is None else a[None] for a in
                tpk.gather_layer_codes(pool_t.k_pages, pool_t.v_pages,
                                       pool_t.k_scale, pool_t.v_scale,
                                       pool_t.page_tables, layer)]
        assert torch.equal(out_t, tfl.mha(
            torch_bf16(q), *rows, torch.from_numpy(pos),
            torch.from_numpy(kv_lens), scale=scale, alibi=ta,
            logit_softcap=CAP, layer=0))
    assert out_j is not None
    np.testing.assert_allclose(_f32(out_t), bf16_to_f32(to_numpy(out_j)),
                               rtol=0, atol=_tol(out_j))
    _sensitive(out_t, uncapped, out_j)


def test_softcap_refusals():
    """A negative or NaN softcap raises; non-causal attention with the
    softcap runs (the plain version, counted as `_softcap_noncausal`) and
    differs from the causal output."""
    gen = torch.Generator().manual_seed(5)
    k = torch.randn((L, B, HKV, S, D), generator=gen).to(torch.bfloat16)
    q = (40 * torch.randn((B, 3, H, D), generator=gen)).to(torch.bfloat16)
    pos = torch.zeros((B, 3), dtype=torch.int32)
    lens = torch.full((B,), 3, dtype=torch.int32)
    for cap in (-1.0, float("nan")):
        with pytest.raises(ValueError, match="logit_softcap"):
            tfl.mha(q, k, k, None, None, pos, lens, scale=1.0, layer=0,
                    logit_softcap=cap)
    name = "flash_prefill_bf16_softcap_noncausal"
    before = _build.plain_dispatches[name]
    out = tfl.mha(q, k, k, None, None, pos, lens, scale=1.0, layer=0,
                  causal=False, logit_softcap=CAP)
    assert _build.plain_dispatches[name] == before + 1
    assert not torch.equal(out, tfl.mha(q, k, k, None, None, pos, lens,
                                        scale=1.0, layer=0,
                                        logit_softcap=CAP))
