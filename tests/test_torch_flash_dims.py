"""The head dims past 64 and 128 and float32 K/V in the attention kernels'
plain versions (kernels B, C, 9 and 10), against the JAX package on the CPU.

* `mha` / `mha_paged` (which route as the kernels do) against the JAX
  entries with NST_FLASH=interpret, which run the Pallas bodies, at head
  dims 72 (a masked dim: the kernels run it through their 80 instance),
  80 (phi-2), 96 (gpt-neox-20b) and 256 (gemma, gpt-j), over int8, bf16
  and float32 K/V, for decode and prefill, contiguous and paged (page size
  128); and 8 query heads over one KV head at 256 (gemma-2b's shape, whose
  decode goes to kernel C).  Tolerance as `test_torch_flash_variants.py`:
  2 bf16 ulps of the largest output.  The int8 decode cases take the extra
  column and the fused append, and the appended rows must equal JAX's
  `append_layer` / `append_decode` byte for byte.
* The float32 fault: the JAX kernels round float32 K and V to bf16 before
  both dots (`astype(bfloat16)` at `neural_speed_tpu/ops/flash.py:209,
  250, 483, 509`); the port's plain versions must too.  With K drawn at a
  standard deviation of 6 the scores are large enough that the unrounded
  float32 products land outside the 2-ulp tolerance.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

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
L, B, S, PS = 2, 2, 256, 128
DIMS = [72, 80, 96, 256]
KVS = ["int8", "bf16", "f32"]


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


def _rows(rng, shape, kv, std=1.0):
    """K/V rows: int8 codes, or normals of standard deviation `std` stored
    as bf16 or float32."""
    if kv == "int8":
        return jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
    x = (rng.standard_normal(shape) * std).astype(np.float32)
    return jax_bf16(x) if kv == "bf16" else jnp.asarray(x)


def _scales(rng, shape, kv):
    if kv != "int8":
        return None
    return jax_bf16(rng.uniform(0.5, 1.5, shape).astype(np.float32) * 0.02)


def _case(kind, h, d, rng, q_std=1.0):
    """Positions and lengths: decode with slot 0 live (a new token at
    kv_len - 1) and slot 1 a spectator parked at S - 1; prefill of 24 rows
    with slot 0's 20 real rows then padding, slot 1 a chunk at offset 90."""
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
    q = jax_bf16((rng.standard_normal((B, t, h, d)) * q_std).astype(
        np.float32))
    return q, pos, kv_lens


def _route(kind, kv, h, hkv):
    """The counter of the plain version `mha` / `mha_paged` must run."""
    if kind == "decode" and tfl.extra_kv_eligible(1, h, hkv):
        name = "flash_decode"
    elif kind == "decode":      # MQA / odd KV head count: the rows body
        name = "flash_rows"
    else:
        name = "flash_prefill"
    return name, kv


def _contiguous(kind, kv, h, hkv, d, rng, k_std=1.0, q_std=1.0):
    """The port's `mha` against JAX `mha` over the stacked cache; with
    int8 decode, the extra column and the fused append, whose rows must
    equal JAX's `append_layer`.  Returns (port output, JAX output)."""
    kc = _rows(rng, (L, B, hkv, S, d), kv, k_std)
    vc = _rows(rng, (L, B, hkv, S, d), kv)
    ks, vs = (_scales(rng, (L, B, hkv, S), kv) for _ in range(2))
    q, pos, kv_lens = _case(kind, h, d, rng, q_std)
    kw = dict(scale=1.0 / math.sqrt(d), layer=1)
    tk, tv, tks, tvs = (None if a is None else _t(a) for a in (kc, vc, ks,
                                                               vs))
    args_t = (torch_bf16(q), tk, tv, tks, tvs, torch.from_numpy(pos),
              torch.from_numpy(kv_lens))
    args_j = (q, kc, vc, ks, vs, jnp.asarray(pos), jnp.asarray(kv_lens))
    if kind == "decode" and kv == "int8" and tfl.extra_kv_eligible(1, h,
                                                                   hkv):
        kn, vn = (jax_bf16(rng.standard_normal((B, 1, hkv, d)).astype(
            np.float32)) for _ in range(2))
        out_j, _ = jfl.mha(*args_j, extra_kv=(kn, vn), fused_append=True,
                           **kw)
        out_t, cache_t = tfl.mha(*args_t, extra_kv=(torch_bf16(kn),
                                                    torch_bf16(vn)),
                                 fused_append=True, **kw)
        live = pos[:, 0] == kv_lens - 1
        want = jkv.append_layer(
            jkv.KVCache(kc, vc, ks, vs, jnp.zeros((B,), jnp.int32)), 1, kn,
            vn, jnp.asarray(np.maximum(kv_lens - 1, 0)[:, None]),
            jnp.asarray(live))
        for got, name in zip(cache_t, ("k", "v", "k_scale", "v_scale")):
            np.testing.assert_array_equal(torch_to_numpy(got),
                                          to_numpy(getattr(want, name)))
        return out_t, out_j
    route, suffix = _route(kind, kv, h, hkv)
    name = route + ("" if kv == "int8" else "_" + suffix)
    before = _build.plain_dispatches[name]
    out_t = tfl.mha(*args_t, **kw)
    assert _build.plain_dispatches[name] == before + 1, name
    return out_t, jfl.mha(*args_j, **kw)


def _pools(hkv, d, kv, rng, k_std=1.0):
    """A JAX pool and the port's with the same bytes; a shuffled table over
    every page but the trash page."""
    nb = S // PS
    n_pages = B * nb + 1
    kc = _rows(rng, (L, hkv, n_pages, PS, d), kv, k_std)
    vc = _rows(rng, (L, hkv, n_pages, PS, d), kv)
    ks, vs = (_scales(rng, (L, hkv, n_pages, 1, PS), kv) for _ in range(2))
    tables = rng.permutation(n_pages - 1).reshape(B, nb).astype(np.int32)
    lens = np.zeros((B,), np.int32)
    jc = jpk.PagedKVCache(kc, vc, ks, vs, jnp.asarray(tables),
                          jnp.asarray(lens))
    tc = tpk.PagedKVCache(*(None if a is None else _t(a)
                            for a in (kc, vc, ks, vs)),
                          torch.from_numpy(tables), torch.from_numpy(lens))
    return jc, tc


def _paged(kind, kv, h, hkv, d, rng, k_std=1.0, q_std=1.0):
    """The port's `mha_paged` against JAX `mha_paged` over the pool (page
    size 128); with int8 decode, the fused append through the table, whose
    rows must equal JAX's `append_decode` on every page but the trash page.
    Without the append the paged plain version must also equal the
    contiguous one over the gathered layer bit for bit."""
    jc, tc = _pools(hkv, d, kv, rng, k_std)
    q, pos, kv_lens = _case(kind, h, d, rng, q_std)
    scale = 1.0 / math.sqrt(d)
    layer = 1
    args_j = (q, jc, layer, jnp.asarray(pos), jnp.asarray(kv_lens))
    args_t = (torch_bf16(q), tc, layer, torch.from_numpy(pos),
              torch.from_numpy(kv_lens))
    if kind == "decode" and kv == "int8" and tfl.extra_kv_eligible(1, h,
                                                                   hkv):
        kn, vn = (jax_bf16(rng.standard_normal((B, 1, hkv, d)).astype(
            np.float32)) for _ in range(2))
        out_j, _ = jfl.mha_paged(*args_j, scale=scale, extra_kv=(kn, vn),
                                 fused_append=True)
        out_t, pool_t = tfl.mha_paged(
            *args_t, scale=scale, extra_kv=(torch_bf16(kn), torch_bf16(vn)),
            fused_append=True)
        live = pos[:, 0] == kv_lens - 1
        want = jpk.append_decode(
            jc, layer, kn, vn,
            jnp.asarray(np.maximum(kv_lens - 1, 0)[:, None]),
            active=jnp.asarray(live))
        n = tc.n_pages - 1
        for got, name in zip(pool_t, ("k_pages", "v_pages", "k_scale",
                                      "v_scale")):
            np.testing.assert_array_equal(
                torch_to_numpy(got)[:, :, :n],
                to_numpy(getattr(want, name))[:, :, :n])
        return out_t, out_j
    out_j = jfl.mha_paged(*args_j, scale=scale)
    out_t = tfl.mha_paged(*args_t, scale=scale)
    rows = [None if a is None else a[None] for a in
            tpk.gather_layer_codes(tc.k_pages, tc.v_pages, tc.k_scale,
                                   tc.v_scale, tc.page_tables, layer)]
    assert torch.equal(out_t, tfl.mha(args_t[0], *rows, args_t[3],
                                      args_t[4], scale=scale, layer=0))
    return out_t, out_j


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("d", DIMS)
def test_head_dims_match_pallas(d, kv, kind, paged):
    """4 query heads over 2 KV heads (decode through kernel B / 10)."""
    rng = np.random.default_rng(d * 11 + KVS.index(kv) * 3
                                + (kind == "decode"))
    run = _paged if paged else _contiguous
    out_t, out_j = run(kind, kv, 4, 2, d, rng)
    assert out_j is not None and out_t.shape == (B, out_j.shape[1], 4, d)
    _close(out_t, out_j)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_eight_query_heads_over_one_kv_head_at_256(kind, paged):
    """Gemma-2B's attention shape over its default bf16 cache: one KV head
    (odd), so decode runs kernel C's plain version, as on the card."""
    rng = np.random.default_rng(77 + (kind == "decode") + 2 * paged)
    run = _paged if paged else _contiguous
    out_t, out_j = run(kind, "bf16", 8, 1, 256, rng)
    assert out_j is not None
    _close(out_t, out_j)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_float32_kv_rounds_to_bf16_as_the_pallas_kernels(kind, paged):
    """Float32 K drawn at a standard deviation of 6 and q at 2, 8 heads,
    D = 64: the JAX kernels round K and V to bf16 before the products, so
    the port's plain versions must too; unrounded, they land 1.1-2.7x the
    2-ulp tolerance away (seeds 0-5)."""
    rng = np.random.default_rng((kind == "decode") + 2 * paged)
    run = _paged if paged else _contiguous
    out_t, out_j = run(kind, "f32", 8, 8, 64, rng, k_std=6.0, q_std=2.0)
    assert out_j is not None
    _close(out_t, out_j)
