"""The int8 score dot (`NST_FLASH_INT8=qk`) in the plain versions of
kernels B and 10, against the JAX package's head-blocked Pallas body
(`_mha_kernel_hblk`, NST_FLASH=interpret) on the CPU.

The JAX flag is read at import (`flash.FLASH_INT8_DOT`); the tests set it
and the port's constant for their own duration, and clear JAX's caches
before and after, since a cached trace keeps the value it was traced with.

q rows are drawn with one element 30x the rest: the per-row int8 scale is
then set by that element and the others quantize to a few levels, which
moves the output far from the float product's (a plain normal q moves it
by about one tolerance).  The softcap cases keep these scores (|s| of a
few units against the cap of 30): they check that the int8 dot composes
with the softcap, which `test_torch_flash_softcap.py` holds by itself.
Held: the outputs within 2 bf16 ulps of the largest output (as
`test_torch_flash_softcap.py`), the fused append's rows equal to JAX's
byte for byte, the output more than 10 of those tolerances from the
port's output without the int8 dot, and the `_qk` counters.
Where the JAX package runs XLA (page size 16, S % 128 != 0) the port's
output equals its output without the int8 dot bit for bit.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
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
L, B, PS = 2, 2, 128
H, HKV = 8, 4
CAP = 30.0


@pytest.fixture(autouse=True)
def _qk_on(monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")
    jax.clear_caches()
    monkeypatch.setattr(jfl, "FLASH_INT8_DOT", True)
    monkeypatch.setattr(tfl, "FLASH_INT8_DOT", True)
    yield
    jax.clear_caches()


def _t(a):
    """A JAX array as the port's tensor with the same bits."""
    if a.dtype == jnp.bfloat16:
        return torch_bf16(a)
    return torch.from_numpy(np.array(a))


def _f32(t: torch.Tensor) -> np.ndarray:
    return bf16_to_f32(torch_to_numpy(t))


def _tol(want_j) -> float:
    return ULPS * ULP * np.abs(bf16_to_f32(to_numpy(want_j))).max()


def _q(rng, d):
    """bf16 q [B, 1, H, D]: each row twice N(0, 1) with one element +-60
    (scores of a few units, where the softmax follows them)."""
    q = rng.standard_normal((B, 1, H, d)).astype(np.float32)
    at = rng.integers(0, d, (B, 1, H, 1))
    np.put_along_axis(q, at, 30.0 * np.where(
        rng.random((B, 1, H, 1)) < 0.5, -1.0, 1.0), -1)
    return jax_bf16(2.0 * q)


def _scales(rng, shape, f32):
    x = rng.uniform(0.5, 1.5, shape).astype(np.float32) * 0.02
    return jnp.asarray(x) if f32 else jax_bf16(x)


def _codes(rng, shape):
    return jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)


def _positions(s):
    """Slot 0 live (the new token at kv_len - 1), slot 1 a spectator parked
    at s - 1."""
    return (np.array([[149], [s - 1]], np.int32),
            np.array([150, 77], np.int32))


def _far(out_t, off_t, want_j):
    """The int8 dot shows: the output without it lies more than 10
    tolerances away."""
    off = np.abs(_f32(out_t) - _f32(off_t)).max()
    assert off > 10 * _tol(want_j), (off, _tol(want_j))


# (head dim, float32 scales, extra column + fused append, ALiBi, softcap)
CASES = [(128, False, True, False, False), (128, True, True, False, False),
         (128, False, False, False, False), (80, False, True, False, False),
         (80, True, False, False, False), (72, False, True, False, False),
         (128, False, True, True, False), (128, True, True, False, True)]


@pytest.mark.parametrize("d,f32,fused,alibi,softcap", CASES,
                         ids=lambda v: str(v))
def test_contiguous_qk_matches_pallas(d, f32, fused, alibi, softcap):
    """`mha` over the stacked int8 cache: with the extra column and the
    fused append, or after a plain append (the port sends that call to
    kernel B under qk, where it goes to kernel C without it)."""
    s = 256
    rng = np.random.default_rng(d + 2 * f32 + 4 * fused + 8 * alibi
                                + 16 * softcap)
    kc, vc = (_codes(rng, (L, B, HKV, s, d)) for _ in range(2))
    ks, vs = (_scales(rng, (L, B, HKV, s), f32) for _ in range(2))
    q = _q(rng, d)
    pos, kv_lens = _positions(s)
    slopes = jat.alibi_slopes(H) if alibi else None
    ta = None if slopes is None else torch.from_numpy(np.array(slopes))
    cap = CAP if softcap else 0.0
    kw = dict(scale=1.0 / math.sqrt(d), layer=1, logit_softcap=cap)
    args_t = lambda: (torch_bf16(q), _t(kc), _t(vc), _t(ks), _t(vs),
                      torch.from_numpy(pos), torch.from_numpy(kv_lens))
    name = ("flash_decode" + ("_f32scale" if f32 else "")
            + ("_softcap" if softcap else "") + "_qk")
    if fused:
        kn, vn = (jax_bf16(rng.standard_normal((B, 1, HKV, d)).astype(
            np.float32)) for _ in range(2))
        extra_t = dict(extra_kv=(torch_bf16(kn), torch_bf16(vn)),
                       fused_append=True)
        out_j, _ = jfl.mha(q, kc, vc, ks, vs, jnp.asarray(pos),
                           jnp.asarray(kv_lens), alibi=slopes,
                           extra_kv=(kn, vn), fused_append=True, **kw)
        before = _build.plain_dispatches[name]
        out_t, cache_t = tfl.mha(*args_t(), alibi=ta, **extra_t, **kw)
        assert _build.plain_dispatches[name] == before + 1
        live = pos[:, 0] == kv_lens - 1
        want = jkv.append_layer(
            jkv.KVCache(kc, vc, ks, vs, jnp.zeros((B,), jnp.int32)), 1,
            kn, vn, jnp.asarray(np.maximum(kv_lens - 1, 0)[:, None]),
            jnp.asarray(live))
        for got, key in zip(cache_t, ("k", "v", "k_scale", "v_scale")):
            np.testing.assert_array_equal(torch_to_numpy(got),
                                          to_numpy(getattr(want, key)))
        tfl.FLASH_INT8_DOT = False
        off_t, _ = tfl.mha(*args_t(), alibi=ta, **extra_t, **kw)
    else:
        out_j = jfl.mha(q, kc, vc, ks, vs, jnp.asarray(pos),
                        jnp.asarray(kv_lens), alibi=slopes, **kw)
        before = _build.plain_dispatches[name]
        out_t = tfl.mha(*args_t(), alibi=ta, **kw)
        assert _build.plain_dispatches[name] == before + 1
        tfl.FLASH_INT8_DOT = False
        prefill = _build.plain_dispatches["flash_prefill"
                                          + name[len("flash_decode"):-3]]
        off_t = tfl.mha(*args_t(), alibi=ta, **kw)
        # without the int8 dot this call goes to kernel C
        assert _build.plain_dispatches[
            "flash_prefill" + name[len("flash_decode"):-3]] == prefill + 1
    assert out_j is not None
    np.testing.assert_allclose(_f32(out_t), bf16_to_f32(to_numpy(out_j)),
                               rtol=0, atol=_tol(out_j))
    _far(out_t, off_t, out_j)


def _pools(rng, d, f32, s=256, ps=PS):
    """A JAX pool and the port's with the same bytes; a shuffled table over
    every page but the trash page."""
    nb = s // ps
    n_pages = B * nb + 1
    kc, vc = (_codes(rng, (L, HKV, n_pages, ps, d)) for _ in range(2))
    ks, vs = (_scales(rng, (L, HKV, n_pages, 1, ps), f32) for _ in range(2))
    tables = rng.permutation(n_pages - 1).reshape(B, nb).astype(np.int32)
    lens = np.zeros((B,), np.int32)
    jc = jpk.PagedKVCache(kc, vc, ks, vs, jnp.asarray(tables),
                          jnp.asarray(lens))
    tc = lambda: tpk.PagedKVCache(
        *(_t(a) for a in (kc, vc, ks, vs)), torch.from_numpy(tables),
        torch.from_numpy(lens))
    return jc, tc


PAGED_CASES = [(128, False, False, False), (128, True, False, False),
               (80, False, False, False), (128, False, True, False),
               (128, False, False, True)]


@pytest.mark.parametrize("d,f32,alibi,softcap", PAGED_CASES,
                         ids=lambda v: str(v))
def test_paged_qk_matches_pallas(d, f32, alibi, softcap):
    """`mha_paged` (page size 128) with the extra column and the fused
    append through the table: the output as JAX's, the pool as JAX's
    `append_decode`, and the paged plain version equal to the contiguous
    one over the gathered layer bit for bit."""
    rng = np.random.default_rng(60 + d + 2 * f32 + 4 * alibi + 8 * softcap)
    jc, tc = _pools(rng, d, f32)
    q = _q(rng, d)
    pos, kv_lens = _positions(256)
    slopes = jat.alibi_slopes(H) if alibi else None
    ta = None if slopes is None else torch.from_numpy(np.array(slopes))
    cap = CAP if softcap else 0.0
    scale, layer = 1.0 / math.sqrt(d), 1
    kn, vn = (jax_bf16(rng.standard_normal((B, 1, HKV, d)).astype(
        np.float32)) for _ in range(2))
    extra_t = dict(extra_kv=(torch_bf16(kn), torch_bf16(vn)),
                   fused_append=True)
    args_t = lambda pool: (torch_bf16(q), pool, layer, torch.from_numpy(pos),
                           torch.from_numpy(kv_lens))
    out_j, _ = jfl.mha_paged(q, jc, layer, jnp.asarray(pos),
                             jnp.asarray(kv_lens), scale=scale, alibi=slopes,
                             logit_softcap=cap, extra_kv=(kn, vn),
                             fused_append=True)
    name = ("flash_decode_paged" + ("_f32scale" if f32 else "")
            + ("_softcap" if softcap else "") + "_qk")
    before = _build.plain_dispatches[name]
    pool_t = tc()
    rows = [a[None] for a in tpk.gather_layer_codes(
        pool_t.k_pages, pool_t.v_pages, pool_t.k_scale, pool_t.v_scale,
        pool_t.page_tables, layer)]
    out_t, _ = tfl.mha_paged(*args_t(pool_t), scale=scale, alibi=ta,
                             logit_softcap=cap, **extra_t)
    assert _build.plain_dispatches[name] == before + 1
    live = pos[:, 0] == kv_lens - 1
    want = jpk.append_decode(jc, layer, kn, vn,
                             jnp.asarray(np.maximum(kv_lens - 1, 0)[:, None]),
                             active=jnp.asarray(live))
    n = pool_t.n_pages - 1
    for key in ("k_pages", "v_pages", "k_scale", "v_scale"):
        np.testing.assert_array_equal(
            torch_to_numpy(getattr(pool_t, key))[:, :, :n],
            to_numpy(getattr(want, key))[:, :, :n])
    contiguous, _ = tfl.mha(torch_bf16(q), *rows, torch.from_numpy(pos),
                            torch.from_numpy(kv_lens), scale=scale, alibi=ta,
                            logit_softcap=cap, layer=0,
                            extra_kv=extra_t["extra_kv"], fused_append=True)
    assert torch.equal(out_t, contiguous)
    np.testing.assert_allclose(_f32(out_t), bf16_to_f32(to_numpy(out_j)),
                               rtol=0, atol=_tol(out_j))
    tfl.FLASH_INT8_DOT = False
    off_t, _ = tfl.mha_paged(*args_t(tc()), scale=scale, alibi=ta,
                             logit_softcap=cap, **extra_t)
    _far(out_t, off_t, out_j)


def test_qk_not_applied_where_jax_runs_xla():
    """Page size 16 and S % 128 != 0: the JAX entries return None (XLA,
    without the int8 dot); the port's outputs equal its qk-off outputs bit
    for bit, counted without `_qk`."""
    rng = np.random.default_rng(7)
    d = 128
    q = _q(rng, d)
    kn, vn = (jax_bf16(rng.standard_normal((B, 1, HKV, d)).astype(
        np.float32)) for _ in range(2))
    extra = dict(extra_kv=(torch_bf16(kn), torch_bf16(vn)), fused_append=True)
    # the page pool at page size 16
    jc, tc = _pools(rng, d, False, ps=16)
    pos, kv_lens = _positions(256)
    args = lambda pool: (torch_bf16(q), pool, 1, torch.from_numpy(pos),
                         torch.from_numpy(kv_lens))
    kw = dict(scale=1.0 / math.sqrt(d))
    assert jfl.mha_paged(q, jc, 1, jnp.asarray(pos), jnp.asarray(kv_lens),
                         extra_kv=(kn, vn), fused_append=True, **kw) is None
    before = dict(_build.plain_dispatches)
    on, _ = tfl.mha_paged(*args(tc()), **extra, **kw)
    assert _build.plain_dispatches["flash_decode_paged"] == before.get(
        "flash_decode_paged", 0) + 1
    tfl.FLASH_INT8_DOT = False
    off, _ = tfl.mha_paged(*args(tc()), **extra, **kw)
    assert torch.equal(on, off)
    # the contiguous cache at S = 192
    tfl.FLASH_INT8_DOT = True
    s = 192
    kc, vc = (_codes(rng, (L, B, HKV, s, d)) for _ in range(2))
    ks, vs = (_scales(rng, (L, B, HKV, s), False) for _ in range(2))
    pos, kv_lens = _positions(s)
    assert jfl.mha(q, kc, vc, ks, vs, jnp.asarray(pos), jnp.asarray(kv_lens),
                   layer=1, **kw) is None
    cargs = lambda: (torch_bf16(q), _t(kc), _t(vc), _t(ks), _t(vs),
                     torch.from_numpy(pos), torch.from_numpy(kv_lens))
    before = _build.plain_dispatches["flash_prefill"]
    on = tfl.mha(*cargs(), layer=1, **kw)
    assert _build.plain_dispatches["flash_prefill"] == before + 1
    tfl.FLASH_INT8_DOT = False
    assert torch.equal(on, tfl.mha(*cargs(), layer=1, **kw))


def test_qk_rule_and_refusals():
    """`int8_dot` follows the JAX gates; several tokens per slot that the
    JAX package sends to its decode body run kernel B's int8 dot over
    several tokens (its plain version here, counted `_qk_multi`; held
    against the Pallas body in `test_torch_flash_qk_multi.py`); the plain
    version refuses the int8 dot over K values; prefill buckets
    (t * n_rep > 8) keep kernel C."""
    rule = tfl.int8_dot
    assert rule(1, 8, 4, 128, True, s=256)
    assert rule(2, 8, 4, 128, True, s=256)           # rp <= 8
    assert not rule(1, 8, 4, 128, False, s=256)      # bf16 cache
    assert not rule(1, 8, 4, 128, True, s=192)       # _supported
    assert not rule(1, 71, 1, 64, True, s=256)       # hb == 1
    assert not rule(1, 4, 1, 128, True, s=256)       # odd Hkv
    assert not rule(1, 32, 2, 128, True, s=256)      # n_rep 16 > 8
    assert not rule(1, 8, 4, 260, True, s=256)       # head dim
    assert rule(1, 8, 4, 128, True, page_size=128, extra=True)
    assert not rule(1, 8, 4, 128, True, page_size=128, extra=False)
    assert not rule(1, 8, 4, 128, True, page_size=16, extra=True)
    tfl.FLASH_INT8_DOT = False
    assert not rule(1, 8, 4, 128, True, s=256)
    tfl.FLASH_INT8_DOT = True

    rng = np.random.default_rng(3)
    s, d = 256, 128
    k, v = (_t(_codes(rng, (L, B, HKV, s, d))) for _ in range(2))
    ks, vs = (_t(_scales(rng, (L, B, HKV, s), False)) for _ in range(2))
    q2 = torch.randn((B, 2, H, d)).to(torch.bfloat16)
    pos = torch.tensor([[10, 11], [20, 21]], dtype=torch.int32)
    lens = torch.tensor([12, 22], dtype=torch.int32)
    before = dict(_build.plain_dispatches)
    out = tfl.mha(q2, k, v, ks, vs, pos, lens, scale=0.1, layer=0)
    assert out.shape == q2.shape
    grown = {n for n, c in _build.plain_dispatches.items()
             if c > before.get(n, 0)}
    assert grown == {"flash_decode_qk_multi"}
    q32 = torch.randn((B, 32, H, d)).to(torch.bfloat16)
    pos = torch.arange(32, dtype=torch.int32)[None].repeat(B, 1)
    lens = torch.full((B,), 32, dtype=torch.int32)
    before = _build.plain_dispatches["flash_prefill"]
    tfl.mha(q32, k, v, ks, vs, pos, lens, scale=0.1, layer=0)
    assert _build.plain_dispatches["flash_prefill"] == before + 1
    kb = torch.randn((L, B, HKV, s, d)).to(torch.bfloat16)
    with pytest.raises(ValueError, match="int8 cache only"):
        tfl.decode_plain(q2[:, :1], None, None, kb, kb, None, None, 0,
                         lens, lens, 0.1, False, torch.bfloat16, qk=True)


@pytest.mark.parametrize("value,want", [("qk", True), ("off", False)])
def test_env_sets_the_constant_at_import(value, want):
    """`NST_FLASH_INT8` in the environment sets the port's constant when
    `ops.flash` is imported, as the JAX package's flag."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("from neural_speed_tpu_torch.ops import flash; "
            "print(flash.FLASH_INT8_DOT)")
    env = dict(os.environ, NST_FLASH_INT8=value, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == str(want)
