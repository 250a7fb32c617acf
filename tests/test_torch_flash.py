"""The port's flash attention (plain versions of kernels B and C, on the CPU)
against the JAX package's Pallas kernels in interpret mode.

Decode with the fused append: the cache written by the port must equal the
JAX kernel's byte for byte (live slots get the quantized new row, the
spectator is untouched), and the outputs agree within 2 bf16 ulps of the
largest output: both sides round q and `P * v_scale` to bf16 at the same
points and take the same single KV block here, so only the f32 summation
order and the bf16 output rounding differ.

Prefill: the same tolerance on every row with a valid column; rows of a
slot with kv_len 0 are exactly 0 in both.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.ops import flash as jfl
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch.ops import attention as tat
from neural_speed_tpu_torch.ops import flash as tfl
from neural_speed_tpu_torch.ops.kv_cache import KVCache

from tests.torch_port_util import (bf16_to_f32, jax_bf16, to_numpy,
                                   torch_bf16, torch_to_numpy)

torch.set_num_threads(1)
ULP = 2.0 ** -8
L, B, H, HKV, S, D = 2, 3, 8, 4, 128, 32


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")


def _cache(rng):
    codes = lambda: jnp.asarray(
        rng.integers(-127, 128, (L, B, HKV, S, D)), jnp.int8)
    scales = lambda: jax_bf16(
        rng.uniform(0.5, 1.5, (L, B, HKV, S)).astype(np.float32) * 0.02)
    return codes(), codes(), scales(), scales()


def _to_torch(arrs):
    conv = lambda a: (torch_bf16(a) if a.dtype == jnp.bfloat16
                      else torch.from_numpy(np.asarray(a).copy()))
    return [conv(a) for a in arrs]


def _close(got_t, want_j):
    got = bf16_to_f32(torch_to_numpy(got_t))
    want = bf16_to_f32(to_numpy(want_j))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * ULP * np.abs(want).max())
    return got, want


def test_decode_fused_append_matches_jax():
    rng = np.random.default_rng(0)
    kc, vc, ks, vs = _cache(rng)
    # slots 0 and 2 live (new token at kv_len - 1); slot 1 a spectator
    # parked at max_len - 1 over its 40 stored rows
    kv_lens = np.array([100, 40, 7], np.int32)
    pos = np.array([[99], [S - 1], [6]], np.int32)
    q = jax_bf16(rng.standard_normal((B, 1, H, D)).astype(np.float32))
    kn = jax_bf16(rng.standard_normal((B, 1, HKV, D)).astype(np.float32))
    vn = jax_bf16(rng.standard_normal((B, 1, HKV, D)).astype(np.float32))
    scale = 1.0 / math.sqrt(D)
    layer = 1
    out_j, cache_j = jfl.mha(q, kc, vc, ks, vs, jnp.asarray(pos),
                             jnp.asarray(kv_lens), scale=scale, layer=layer,
                             extra_kv=(kn, vn), fused_append=True)
    tk, tv, tks, tvs = _to_torch([kc, vc, ks, vs])
    before = _build.plain_dispatches["flash_decode"]
    out_t, cache_t = tfl.mha(
        torch_bf16(q), tk, tv, tks, tvs, torch.from_numpy(pos),
        torch.from_numpy(kv_lens), scale=scale, layer=layer,
        extra_kv=(torch_bf16(kn), torch_bf16(vn)), fused_append=True)
    assert _build.plain_dispatches["flash_decode"] == before + 1
    for got, want in zip(cache_t, cache_j):
        np.testing.assert_array_equal(torch_to_numpy(got), to_numpy(want))
    # the port wrote in place; the rows really changed for live slots only
    assert not np.array_equal(torch_to_numpy(tk), to_numpy(kc))
    np.testing.assert_array_equal(torch_to_numpy(tk)[:, 1], to_numpy(kc)[:, 1])
    _close(out_t, out_j)


def test_prefill_matches_jax_and_masked_rows_are_zero():
    rng = np.random.default_rng(1)
    kc, vc, ks, vs = _cache(rng)
    t = 24
    # slot 0: 20 real rows + padding on the trash position; slot 1: a
    # spectator with nothing stored (kv_len 0, every row masked); slot 2: a
    # chunk at offset 50 over its earlier rows
    kv_lens = np.array([20, 0, 74], np.int32)
    ar = np.arange(t)[None]
    pos = np.stack([np.where(ar[0] < 20, ar[0], S - 1), ar[0], 50 + ar[0]]
                   ).astype(np.int32)
    q = jax_bf16(rng.standard_normal((B, t, H, D)).astype(np.float32))
    scale = 1.0 / math.sqrt(D)
    layer = 0
    out_j = jfl.mha(q, kc, vc, ks, vs, jnp.asarray(pos), jnp.asarray(kv_lens),
                    scale=scale, layer=layer)
    tk, tv, tks, tvs = _to_torch([kc, vc, ks, vs])
    out_t = tfl.mha(torch_bf16(q), tk, tv, tks, tvs, torch.from_numpy(pos),
                    torch.from_numpy(kv_lens), scale=scale, layer=layer)
    got, want = _close(out_t, out_j)
    assert np.all(got[1] == 0) and np.all(want[1] == 0)


def test_prefill_matches_jax_natural_layout(monkeypatch):
    """The JAX natural-layout prefill (`_mha_packed_nat`, behind
    NST_FLASH_NATQ=1, at a token count that tiles its row block: t % 128
    == 0 with 2 query heads per KV head) against the port's `mha`, whose
    kernel C reads q and writes the output in the natural [B, T, H, D]
    layout by construction.  Same tolerance as the packed route."""
    monkeypatch.setenv("NST_FLASH_NATQ", "1")
    calls = []
    nat = jfl._mha_packed_nat
    monkeypatch.setattr(jfl, "_mha_packed_nat",
                        lambda *a, **k: calls.append(1) or nat(*a, **k))
    rng = np.random.default_rng(4)
    kc, vc, ks, vs = _cache(rng)
    t = 128
    kv_lens = np.array([t, 100, 77], np.int32)
    ar = np.arange(t)
    pos = np.stack([ar, np.where(ar < 100, ar, S - 1),
                    np.where(ar < 77, ar, S - 1)]).astype(np.int32)
    q = jax_bf16(rng.standard_normal((B, t, H, D)).astype(np.float32))
    scale = 1.0 / math.sqrt(D)
    out_j = jfl.mha(q, kc, vc, ks, vs, jnp.asarray(pos), jnp.asarray(kv_lens),
                    scale=scale, layer=1)
    assert calls, "the JAX natural-layout launcher did not run"
    tk, tv, tks, tvs = _to_torch([kc, vc, ks, vs])
    out_t = tfl.mha(torch_bf16(q), tk, tv, tks, tvs, torch.from_numpy(pos),
                    torch.from_numpy(kv_lens), scale=scale, layer=1)
    _close(out_t, out_j)


def test_attention_cache_flash_route_matches_reference():
    """attention_cache's default (flash) route against its f32 reference
    route over the same cache: bf16 rounding of q and P * v_scale only."""
    rng = np.random.default_rng(2)
    tk, tv, tks, tvs = _to_torch(_cache(rng))
    cache = KVCache(tk, tv, tks, tvs, torch.zeros((B,), dtype=torch.int32))
    t = 8
    q = torch_bf16(jax_bf16(rng.standard_normal((B, t, H, D)).astype(
        np.float32)))
    pos = torch.arange(t, dtype=torch.int32)[None].repeat(B, 1) + 30
    kv_lens = torch.tensor([38, 38, 35], dtype=torch.int32)
    flash_out = tat.attention_cache(q, cache, 1, pos, kv_lens).float()
    ref = tat.attention_cache(q, cache, 1, pos, kv_lens,
                              use_flash=False).float()
    valid = (pos < kv_lens[:, None])[..., None, None].expand_as(ref)
    np.testing.assert_allclose(flash_out[valid].numpy(), ref[valid].numpy(),
                               rtol=0, atol=8 * ULP * ref.abs().max().item())


def test_kernel_wrappers_refuse_what_the_kernels_cannot_index():
    """The checks that run before a kernel launch (pure Python, so they are
    exercised here on CPU tensors): a layer past L, positions or lengths of
    another batch, or a head_dim the kernels were not built for raise."""
    k = torch.zeros((2, B, HKV, 128, 64), dtype=torch.int8)
    ks = torch.zeros(k.shape[:4], dtype=torch.bfloat16)
    q = torch.zeros((B, 4, H, 64), dtype=torch.bfloat16)
    pos = torch.zeros((B, 4), dtype=torch.int32)
    lens = torch.ones((B,), dtype=torch.int32)
    tfl._check_cache(k, k, ks, ks, 1, pos, lens, q)
    bad = [dict(layer=2), dict(pos=pos[:1]), dict(lens=lens[:2]),
           dict(q=torch.zeros((B, 4, H, 32), dtype=torch.bfloat16))]
    for kw in bad:
        args = dict(layer=1, pos=pos, lens=lens, q=q) | kw
        with pytest.raises(ValueError):
            tfl._check_cache(k, k, ks, ks, args["layer"], args["pos"],
                             args["lens"], args["q"])


def test_off_the_cpu_no_plain_version_runs():
    """Only CPU tensors run the plain versions and the f32 reference: a
    tensor on another device (meta here, which no kernel takes) reaches the
    kernels' checks, and the reference route raises, for prefill, decode
    with extra k/v, and `use_flash=False`; with and without ALiBi slopes,
    over the int8 cache and over the bf16 one (prefill and decode)."""
    meta = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device="meta")
    k = meta((L, B, HKV, S, D), torch.int8)
    ks = meta((L, B, HKV, S), torch.bfloat16)
    cache = KVCache(k, k, ks, ks, meta((B,), torch.int32))
    kb = meta((L, B, HKV, S, D), torch.bfloat16)
    bf16 = KVCache(kb, kb, None, None, meta((B,), torch.int32))
    lens = meta((B,), torch.int32)
    kn = meta((B, 1, HKV, D), torch.bfloat16)
    before = dict(_build.plain_dispatches)
    for alibi in (None, meta((H,), torch.float32)):
        for c, t, kw in ((cache, 4, {}), (cache, 1, dict(extra_kv=(kn, kn))),
                         (cache, 1, dict(extra_kv=(kn, kn),
                                         fused_append=True)),
                         (cache, 4, dict(use_flash=False)), (bf16, 4, {}),
                         (bf16, 1, {}), (bf16, 1, dict(use_flash=False))):
            q = meta((B, t, H, D), torch.bfloat16)
            pos = meta((B, t), torch.int32)
            with pytest.raises(ValueError):
                tat.attention_cache(q, c, 1, pos, lens, alibi=alibi, **kw)
    assert dict(_build.plain_dispatches) == before
