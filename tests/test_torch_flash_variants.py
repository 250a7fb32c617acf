"""The attention variants of kernels B, C, 9 and 10 (ALiBi slopes, bf16 K/V)
and the bf16 caches, against the JAX package on the CPU.

* `alibi_slopes`: equal to the JAX schedule bit for bit for 1-80 heads
  (powers of two and the other branch).
* The port's plain versions (through `mha` / `mha_paged`, which route as
  the kernels do) against the JAX entries with NST_FLASH=interpret, which
  run the Pallas bodies: `_mha_packed_hblk` / `_mha_packed` over the
  stacked cache, `_mha_paged_hblk` / `_mha_paged` over the pool.  ALiBi
  over int8 and bf16 K/V, decode and prefill, contiguous and paged, at 32
  and 40 query heads (power-of-two and other slopes) and n_rep 1, 4 and
  71 (Falcon-7B's 71 query heads over one KV head).  Tolerance as
  `test_torch_flash.py`: 2 bf16 ulps of the largest output; both sides
  round q and P (times the V scale) to bf16 at the same points, so only
  the f32 summation order, the online-softmax rescale across pages and the
  bf16 output rounding differ.  The int8 decode cases with an even KV head
  count take the extra column and the fused append, and the appended
  cache must equal byte for byte what JAX's `append_layer` /
  `append_decode` write for the live slots: the JAX fused kernel's own
  contract.  (Run in interpret mode on the CPU, the JAX kernel itself
  rounds one code in 655360 the other way at 40 heads: XLA's division
  there is not the IEEE one that `quantize_kv` and the port use.)
* The bf16 `KVCache` and page pool after prefill and decode appends equal
  JAX's bit for bit (the pool on every page but the trash page).
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
from neural_speed_tpu_torch.ops import attention as tat
from neural_speed_tpu_torch.ops import flash as tfl
from neural_speed_tpu_torch.ops import kv_cache as tkv
from neural_speed_tpu_torch.ops import paged_kv as tpk

from tests.torch_port_util import (bf16_to_f32, jax_bf16, to_numpy,
                                   torch_bf16, torch_to_numpy)

torch.set_num_threads(1)
ULP = 2.0 ** -8
L, B, S, PS = 2, 2, 256, 128


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


def test_alibi_slopes_bit_identical():
    for n in range(1, 81):
        np.testing.assert_array_equal(tat.alibi_slopes(n).numpy(),
                                      np.asarray(jat.alibi_slopes(n)),
                                      err_msg=str(n))


def _rows(rng, shape, bf16):
    """K/V rows: bf16 normals, or int8 codes."""
    if bf16:
        return jax_bf16(rng.standard_normal(shape).astype(np.float32))
    return jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)


def _scales(rng, shape, bf16):
    if bf16:
        return None
    return jax_bf16(rng.uniform(0.5, 1.5, shape).astype(np.float32) * 0.02)


def _case(kind, h, hkv, d, rng):
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
    q = jax_bf16(rng.standard_normal((B, t, h, d)).astype(np.float32))
    return q, pos, kv_lens


HEADS = [(32, 32, 16), (40, 40, 16), (32, 8, 16), (71, 1, 16)]


@pytest.mark.parametrize("kv", ["int8", "bf16"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("h,hkv,d", HEADS, ids=lambda v: str(v))
def test_contiguous_variants_match_pallas(kind, kv, h, hkv, d):
    """ALiBi over the stacked cache through `mha`."""
    rng = np.random.default_rng(h * 7 + hkv + (kind == "decode"))
    bf16 = kv == "bf16"
    kc, vc = (_rows(rng, (L, B, hkv, S, d), bf16) for _ in range(2))
    ks, vs = (_scales(rng, (L, B, hkv, S), bf16) for _ in range(2))
    q, pos, kv_lens = _case(kind, h, hkv, d, rng)
    slopes = jat.alibi_slopes(h)
    scale = 1.0 / math.sqrt(d)
    layer = 1
    fused = (kind == "decode" and not bf16
             and tfl.extra_kv_eligible(1, h, hkv))
    kw = dict(scale=scale, layer=layer)
    tk, tv, tks, tvs = (None if a is None else _t(a) for a in (kc, vc, ks,
                                                               vs))
    ta = torch.from_numpy(np.array(slopes))
    if fused:
        kn, vn = (jax_bf16(rng.standard_normal((B, 1, hkv, d)).astype(
            np.float32)) for _ in range(2))
        out_j, _ = jfl.mha(q, kc, vc, ks, vs, jnp.asarray(pos),
                           jnp.asarray(kv_lens), alibi=slopes,
                           extra_kv=(kn, vn), fused_append=True, **kw)
        out_t, cache_t = tfl.mha(
            torch_bf16(q), tk, tv, tks, tvs, torch.from_numpy(pos),
            torch.from_numpy(kv_lens), alibi=ta,
            extra_kv=(torch_bf16(kn), torch_bf16(vn)), fused_append=True,
            **kw)
        live = pos[:, 0] == kv_lens - 1
        want = jkv.append_layer(
            jkv.KVCache(kc, vc, ks, vs, jnp.zeros((B,), jnp.int32)), layer,
            kn, vn, jnp.asarray(np.maximum(kv_lens - 1, 0)[:, None]),
            jnp.asarray(live))
        for got, name in zip(cache_t, ("k", "v", "k_scale", "v_scale")):
            np.testing.assert_array_equal(torch_to_numpy(got),
                                          to_numpy(getattr(want, name)))
    else:
        out_j = jfl.mha(q, kc, vc, ks, vs, jnp.asarray(pos),
                        jnp.asarray(kv_lens), alibi=slopes, **kw)
        eligible = tfl.extra_kv_eligible(1, h, hkv)
        route = ("flash_decode" if kind == "decode" and bf16 and eligible
                 else "flash_rows" if kind == "decode" and not eligible
                 else "flash_prefill")
        name = route + ("_bf16" if bf16 else "")
        before = _build.plain_dispatches[name]
        out_t = tfl.mha(torch_bf16(q), tk, tv, tks, tvs,
                        torch.from_numpy(pos), torch.from_numpy(kv_lens),
                        alibi=ta, **kw)
        assert _build.plain_dispatches[name] == before + 1
    assert out_j is not None
    _close(out_t, out_j)


def _pools(hkv, d, bf16, rng):
    """A JAX pool and the port's with the same bytes; a shuffled table over
    every page but the trash page."""
    nb = S // PS
    n_pages = B * nb + 1
    kc, vc = (_rows(rng, (L, hkv, n_pages, PS, d), bf16) for _ in range(2))
    ks, vs = (_scales(rng, (L, hkv, n_pages, 1, PS), bf16) for _ in range(2))
    tables = rng.permutation(n_pages - 1).reshape(B, nb).astype(np.int32)
    lens = np.zeros((B,), np.int32)
    jc = jpk.PagedKVCache(kc, vc, ks, vs, jnp.asarray(tables),
                          jnp.asarray(lens))
    tc = tpk.PagedKVCache(*(None if a is None else _t(a)
                            for a in (kc, vc, ks, vs)),
                          torch.from_numpy(tables), torch.from_numpy(lens))
    return jc, tc


@pytest.mark.parametrize("kv", ["int8", "bf16"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("h,hkv,d", HEADS, ids=lambda v: str(v))
def test_paged_variants_match_pallas(kind, kv, h, hkv, d):
    """ALiBi over the page pool through `mha_paged` (page size 128)."""
    rng = np.random.default_rng(h * 5 + hkv + (kind == "decode"))
    bf16 = kv == "bf16"
    jc, tc = _pools(hkv, d, bf16, rng)
    q, pos, kv_lens = _case(kind, h, hkv, d, rng)
    slopes = jat.alibi_slopes(h)
    ta = torch.from_numpy(np.array(slopes))
    scale = 1.0 / math.sqrt(d)
    layer = 1
    fused = (kind == "decode" and not bf16
             and tfl.extra_kv_eligible(1, h, hkv))
    args_j = (q, jc, layer, jnp.asarray(pos), jnp.asarray(kv_lens))
    args_t = (torch_bf16(q), tc, layer, torch.from_numpy(pos),
              torch.from_numpy(kv_lens))
    if fused:
        kn, vn = (jax_bf16(rng.standard_normal((B, 1, hkv, d)).astype(
            np.float32)) for _ in range(2))
        out_j, _ = jfl.mha_paged(*args_j, scale=scale, alibi=slopes,
                                 extra_kv=(kn, vn), fused_append=True)
        out_t, pool_t = tfl.mha_paged(
            *args_t, scale=scale, alibi=ta,
            extra_kv=(torch_bf16(kn), torch_bf16(vn)), fused_append=True)
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
    else:
        out_j = jfl.mha_paged(*args_j, scale=scale, alibi=slopes)
        out_t = tfl.mha_paged(*args_t, scale=scale, alibi=ta)
    assert out_j is not None
    _close(out_t, out_j)
    # the paged plain versions equal the contiguous ones over the gathered
    # layer bit for bit
    if not fused:
        rows = [None if a is None else a[None] for a in
                tpk.gather_layer_codes(tc.k_pages, tc.v_pages, tc.k_scale,
                                       tc.v_scale, tc.page_tables, layer)]
        assert torch.equal(out_t, tfl.mha(
            args_t[0], *rows, args_t[3], args_t[4], scale=scale, alibi=ta,
            layer=0))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_bf16_caches_bit_identical(paged):
    """Prefill (slot 0's 11 real rows and padding, slot 1 inactive) then
    three decode appends with slot 1 a spectator: the bf16 cache or pool
    equals JAX's bit for bit."""
    rng = np.random.default_rng(31 + paged)
    h, d, s, t = 4, 16, 256, 16
    if paged:
        nb, ps = s // 16, 16
        n_pages = 2 * nb + 1
        tables = rng.permutation(n_pages - 1).reshape(2, nb).astype(np.int32)
        jc = jpk.init_paged_cache(L, 2, s, h, d, n_pages, ps)
        jc = jpk.PagedKVCache(jc.k_pages, jc.v_pages, None, None,
                              jnp.asarray(tables), jc.lengths)
        tc = tpk.init_paged_cache(L, 2, s, h, d, n_pages, ps, device="cpu")
        tc.page_tables.copy_(torch.from_numpy(tables))
        span, dec = (jpk.append_span, tpk.append_span), (jpk.append_decode,
                                                         tpk.append_decode)
    else:
        jc = jkv.init_cache(L, 2, s, h, d)
        tc = tkv.init_cache(L, 2, s, h, d, device="cpu")
        span = dec = (jkv.append_layer, tkv.append_layer)
    assert not tc.quantized

    def same():
        names = ("k_pages", "v_pages") if paged else ("k", "v")
        for name in names:
            want = to_numpy(getattr(jc, name))
            got = torch_to_numpy(getattr(tc, name))
            if paged:
                want, got = want[:, :, :-1], got[:, :, :-1]
            np.testing.assert_array_equal(got, want, err_msg=name)

    kv = lambda n: [jax_bf16(rng.standard_normal((2, n, h, d)).astype(
        np.float32)) for _ in range(2)]
    lens = np.array([11, 0], np.int32)
    ar = np.arange(t)[None]
    pos = np.where(ar < lens[:, None], ar, s - 1).astype(np.int32)
    active = lens > 0
    k, v = kv(t)
    jc = span[0](jc, 1, k, v, jnp.asarray(pos), active=jnp.asarray(active))
    span[1](tc, 1, torch_bf16(k), torch_bf16(v), torch.from_numpy(pos),
            active=torch.from_numpy(active))
    same()
    lengths = lens.copy()
    for _ in range(3):
        k, v = kv(1)
        act = np.array([True, False])
        p = np.where(act, lengths, s - 1)[:, None].astype(np.int32)
        for layer in range(L):
            jc = dec[0](jc, layer, k, v, jnp.asarray(p),
                        active=jnp.asarray(act))
            dec[1](tc, layer, torch_bf16(k), torch_bf16(v),
                   torch.from_numpy(p), active=torch.from_numpy(act))
        lengths = lengths + act
        same()


def test_open_variants_raise_naming_the_roadmap():
    """Non-causal attention runs (the plain versions on the CPU) and, at
    positions 0 over three columns, differs from causal; a softcap runs
    and changes the output.  Float32 K/V runs on the CPU (the plain versions) and,
    over meta tensors, passes the cache checks and stops only at the
    kernels' device check, with no ROADMAP error; so do head dims that are
    multiples of 8 up to 256.  Other head dims raise, naming the rule.  The
    engines build a float32 cache off the CPU."""
    from neural_speed_tpu_torch.models.arch import ArchConfig
    from neural_speed_tpu_torch.runtime.engine import Engine

    k = torch.zeros((L, B, 4, S, 16), dtype=torch.bfloat16)
    q = torch.zeros((B, 3, 8, 16), dtype=torch.bfloat16)
    pos = torch.zeros((B, 3), dtype=torch.int32)
    lens = torch.ones((B,), dtype=torch.int32)
    gen = torch.Generator().manual_seed(3)
    kr = torch.randn(k.shape, generator=gen).to(torch.bfloat16)
    qr = (40 * torch.randn(q.shape, generator=gen)).to(torch.bfloat16)
    lens_r = torch.full((B,), 3, dtype=torch.int32)
    noncausal = tfl.mha(qr, kr, kr, None, None, pos, lens_r, scale=1.0,
                        layer=0, causal=False)
    assert noncausal.shape == q.shape
    assert not torch.equal(noncausal, tfl.mha(qr, kr, kr, None, None, pos,
                                              lens_r, scale=1.0, layer=0))
    pos_r = torch.arange(3, dtype=torch.int32).expand(B, 3).contiguous()
    capped = tfl.mha(qr, kr, kr, None, None, pos_r, lens_r, scale=1.0,
                     layer=0, logit_softcap=2.0)
    assert capped.shape == q.shape
    assert not torch.equal(capped, tfl.mha(qr, kr, kr, None, None, pos_r,
                                           lens_r, scale=1.0, layer=0))
    f32 = k.float()
    out = tfl.mha(q, f32, f32, None, None, pos, lens, scale=1.0, layer=0)
    assert out.shape == q.shape
    meta = lambda *a: [x.to("meta") for x in a]
    for d in (16, 72, 80, 96, 256):
        kd, qd = torch.zeros(k.shape[:4] + (d,)), torch.zeros(q.shape[:3]
                                                             + (d,))
        for cache in (kd, kd.to(torch.bfloat16)):
            with pytest.raises(ValueError, match="takes CUDA tensors") as e:
                tfl.mha(*meta(qd.to(torch.bfloat16), cache, cache), None,
                        None, *meta(pos, lens), scale=1.0, layer=0)
            assert "ROADMAP" not in str(e.value)
    for d in (20, 264):
        kd = torch.zeros(k.shape[:4] + (d,), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="multiples of 8 up to 256"):
            tfl.mha(*meta(torch.zeros(q.shape[:3] + (d,),
                                      dtype=torch.bfloat16), kd, kd), None,
                    None, *meta(pos, lens), scale=1.0, layer=0)
    cfg = ArchConfig(name="llama", vocab_size=64, hidden_size=64, n_layers=1,
                     n_heads=4, n_kv_heads=2, intermediate_size=128)
    for dev in ("cpu", "meta"):
        eng = Engine({"layers": []}, cfg, max_len=128,
                     kv_dtype=torch.float32, device=dev)
        assert eng.cache.k.dtype == torch.float32 and not eng.cache.quantized


@pytest.mark.parametrize("softcap", [0.0, 30.0], ids=["plain", "softcap"])
def test_attention_ref_and_attention_match_jax(softcap):
    """`attention_ref` (ALiBi at 40 heads over 8 KV heads, with and without
    grok's softcap) against JAX's float32 reference: float32 math on both
    sides, so 2 bf16 ulps (the output rounding) bound the difference; then
    `attention` (the flash route's plain version over bf16 K/V) against
    JAX's `attention` with its Pallas kernel in interpret mode, with and
    without the softcap."""
    rng = np.random.default_rng(41)
    h, hkv, d, s, t = 40, 8, 16, 128, 12
    q = jax_bf16(rng.standard_normal((B, t, h, d)).astype(np.float32))
    k, v = (jax_bf16(rng.standard_normal((B, s, hkv, d)).astype(np.float32))
            for _ in range(2))
    ar = np.arange(t)
    pos = np.stack([ar, 60 + ar]).astype(np.int32)
    kv_lens = np.array([t, 60 + t], np.int32)
    slopes = jat.alibi_slopes(h)
    args_j = (q, k, v, jnp.asarray(pos), jnp.asarray(kv_lens))
    args_t = (torch_bf16(q), torch_bf16(k), torch_bf16(v),
              torch.from_numpy(pos), torch.from_numpy(kv_lens))
    ta = torch.from_numpy(np.array(slopes))
    _close(tat.attention_ref(*args_t, alibi=ta, logit_softcap=softcap),
           jat.attention_ref(*args_j, alibi=slopes, logit_softcap=softcap))
    _close(tat.attention(*args_t, alibi=ta, logit_softcap=softcap),
           jat.attention(*args_j, alibi=slopes, logit_softcap=softcap,
                         use_flash=True))
