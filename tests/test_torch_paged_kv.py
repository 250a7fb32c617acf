"""The port's paged KV pool (`ops/paged_kv.py`) and paged attention (plain
versions of the two paged kernels, on the CPU) against the JAX package.

* `PageAllocator`: the same operations leave the same free lists and
  reference counts, and a double free raises in both.
* `append_span` / `append_decode` on shuffled page tables: codes, bf16
  scales and lengths equal JAX's bit for bit on every page but the trash
  page (padding rows and inactive slots park there; which of several
  parked writes lands last is not defined in either package).
* `gathered_layer`: equal bit for bit.
* `mha_paged`: at page size 128 against the JAX Pallas kernels in
  interpret mode, at page size 16 against the JAX XLA route.  Outputs
  within 2 bf16 ulps of the largest output where both sides round q and
  P * v_scale to bf16 at the same points (the Pallas kernels), within 8
  against the float32 XLA route (as `test_torch_flash.py` holds the
  contiguous flash route against its reference).  The fused append leaves
  every non-trash page equal to JAX's bit for bit.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.ops import attention as jat
from neural_speed_tpu.ops import flash as jfl
from neural_speed_tpu.ops import paged_kv as jpk
from neural_speed_tpu.ops.kv_cache import quantize_kv as jquantize_kv
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch.ops import attention as tat
from neural_speed_tpu_torch.ops import flash as tfl
from neural_speed_tpu_torch.ops import paged_kv as tpk

from tests.torch_port_util import (bf16_to_f32, jax_bf16, to_numpy,
                                   torch_bf16, torch_to_numpy)

torch.set_num_threads(1)
ULP = 2.0 ** -8
L, B, H, HKV, D = 2, 3, 8, 4, 32


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")


def _pools(ps, n_blocks, n_pages, seed):
    """A JAX pool filled with quantized noise, shuffled tables that never
    name the trash page (the last), and the same pool in the port."""
    rng = np.random.default_rng(seed)
    shape = (L, HKV, n_pages, ps, D)
    kc, ks = jquantize_kv(jnp.asarray(rng.standard_normal(shape), jnp.float32))
    vc, vs = jquantize_kv(jnp.asarray(rng.standard_normal(shape), jnp.float32))
    ks = ks.transpose(0, 1, 2, 4, 3).astype(jnp.bfloat16)
    vs = vs.transpose(0, 1, 2, 4, 3).astype(jnp.bfloat16)
    tables = rng.permutation(n_pages - 1)[:B * n_blocks].reshape(B, n_blocks)
    lens = np.zeros((B,), np.int32)
    jc = jpk.PagedKVCache(kc, vc, ks, vs, jnp.asarray(tables, jnp.int32),
                          jnp.asarray(lens))
    tc = tpk.PagedKVCache(
        torch.from_numpy(np.asarray(kc).copy()),
        torch.from_numpy(np.asarray(vc).copy()), torch_bf16(ks),
        torch_bf16(vs), torch.from_numpy(tables.astype(np.int32)),
        torch.from_numpy(lens))
    return jc, tc, rng


def _pool_arrays(c, port):
    conv = torch_to_numpy if port else to_numpy
    return [conv(getattr(c, n)).copy() for n in ("k_pages", "v_pages",
                                                 "k_scale", "v_scale")]


def _assert_pools_equal(tc, jc, changed_from=None):
    """Every page but the trash page equal bit for bit; with `changed_from`
    (the pool before), also that the write really changed something."""
    n = jc.k_pages.shape[2] - 1
    for name, got, want in zip(("k", "v", "ks", "vs"), _pool_arrays(tc, True),
                               _pool_arrays(jc, False)):
        np.testing.assert_array_equal(got[:, :, :n], want[:, :, :n],
                                      err_msg=name)
    if changed_from is not None:
        assert not np.array_equal(_pool_arrays(tc, True)[0][:, :, :n],
                                  changed_from[0][:, :, :n])


def _kv(rng, b, t):
    return [jax_bf16(rng.standard_normal((b, t, HKV, D)).astype(np.float32))
            for _ in range(2)]


def test_page_allocator_matches_jax():
    ja, ta = jpk.PageAllocator(12), tpk.PageAllocator(12)

    def same():
        assert sorted(ta.free) == sorted(ja.free)
        assert ta.refs == ja.refs and ta.available == ja.available

    ops = [("alloc_run", 3), ("alloc_run", 4), ("alloc_page",),
           ("free", [1, 2]), ("alloc_run", 2), ("alloc_run", 3),
           ("share", [4, 5]), ("free", [4, 5, 6]), ("free", [4]),
           ("alloc_page",), ("alloc_run", 12), ("free", [0, 3])]
    for op in ops:
        if op[0] == "alloc_run":
            assert ta.alloc_run(op[1]) == ja.alloc_run(op[1])
        elif op[0] == "alloc_page":
            assert ta.alloc_page() == ja.alloc_page()
        elif op[0] == "share":
            ta.share_pages(op[1])
            ja.share_pages(op[1])
        else:
            ta.free_pages(op[1])
            ja.free_pages(op[1])
        same()
    # fragmentation: a run longer than any free stretch fails in both
    assert ta.alloc_run(6) is None and ja.alloc_run(6) is None
    page = ta.free[0]
    for alloc in (ta, ja):
        with pytest.raises(RuntimeError, match="double free"):
            alloc.free_pages([page])


@pytest.mark.parametrize("ps", [16, 128])
def test_append_span_matches_jax(ps):
    n_blocks, n_pages = 256 // ps, 3 * (256 // ps) + 2
    jc, tc, rng = _pools(ps, n_blocks, n_pages, seed=ps)
    before = _pool_arrays(tc, True)
    t = 24
    # slot 0: a prompt of 20 rows + padding parked at max_len - 1; slot 1:
    # inactive; slot 2: a span across a page boundary (from ps - 5)
    s = n_blocks * ps
    ar = np.arange(t)
    pos = np.stack([np.where(ar < 20, ar, s - 1), ar, ps - 5 + ar]
                   ).astype(np.int32)
    active = np.array([True, False, True])
    k, v = _kv(rng, B, t)
    layer = 1
    jc = jpk.append_span(jc, layer, k, v, jnp.asarray(pos),
                         active=jnp.asarray(active))
    got = tpk.append_span(tc, layer, torch_bf16(k), torch_bf16(v),
                          torch.from_numpy(pos), torch.from_numpy(active))
    assert got is tc
    _assert_pools_equal(tc, jc, before)
    np.testing.assert_array_equal(torch_to_numpy(tc.lengths),
                                  np.asarray(jc.lengths))


@pytest.mark.parametrize("ps", [16, 128])
def test_append_decode_matches_jax(ps):
    n_blocks, n_pages = 256 // ps, 3 * (256 // ps) + 2
    jc, tc, rng = _pools(ps, n_blocks, n_pages, seed=ps + 1)
    before = _pool_arrays(tc, True)
    # slot 0 on the first row of its second page, slot 1 inactive, slot 2
    # at the last position of the cache (the trash position's clamp)
    s = n_blocks * ps
    pos = np.array([[ps], [7], [s - 1]], np.int32)
    active = np.array([True, False, True])
    k, v = _kv(rng, B, 1)
    for layer in (0, 1):
        jc = jpk.append_decode(jc, layer, k, v, jnp.asarray(pos),
                               active=jnp.asarray(active))
        tpk.append_decode(tc, layer, torch_bf16(k), torch_bf16(v),
                          torch.from_numpy(pos), torch.from_numpy(active))
    _assert_pools_equal(tc, jc, before)


@pytest.mark.parametrize("ps", [16, 128])
def test_gathered_layer_matches_jax(ps):
    jc, tc, _ = _pools(ps, 256 // ps, 3 * (256 // ps) + 2, seed=3)
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        for got, want in zip(tpk.gathered_layer(tc, 1, dtype),
                             jpk.gathered_layer(jc, 1, jdt)):
            np.testing.assert_array_equal(torch_to_numpy(got),
                                          to_numpy(want))


def _close(got_t, want, ulps):
    got = bf16_to_f32(torch_to_numpy(got_t)) if got_t.dtype == \
        torch.bfloat16 else got_t.float().numpy()
    want = np.asarray(want, np.float32) if want.dtype != jnp.bfloat16 else \
        bf16_to_f32(to_numpy(want))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ulps * ULP * np.abs(want).max())
    return got, want


def _decode_case(ps, seed):
    n_blocks, n_pages = 384 // ps, 3 * (384 // ps) + 2
    jc, tc, rng = _pools(ps, n_blocks, n_pages, seed)
    s = n_blocks * ps
    # slot 0: the new row opens its second page (rows crossing a page);
    # slot 1: a spectator parked at max_len - 1 over 40 stored rows;
    # slot 2: deep into its third page
    kv_lens = np.array([ps + 1, 40, 2 * ps + 9], np.int32)
    pos = np.array([[ps], [s - 1], [2 * ps + 8]], np.int32)
    q = jax_bf16(rng.standard_normal((B, 1, H, D)).astype(np.float32))
    kn, vn = _kv(rng, B, 1)
    return jc, tc, q, kn, vn, pos, kv_lens


def test_mha_paged_decode_fused_matches_pallas_kernel():
    """Page size 128: the port's plain version of the paged decode kernel
    against `_mha_paged_hblk` in interpret mode, fused append."""
    jc, tc, q, kn, vn, pos, kv_lens = _decode_case(128, seed=11)
    before = _pool_arrays(tc, True)
    scale = 1.0 / math.sqrt(D)
    layer = 1
    out_j, pool_j = jfl.mha_paged(q, jc, layer, jnp.asarray(pos),
                                  jnp.asarray(kv_lens), scale=scale,
                                  extra_kv=(kn, vn), fused_append=True)
    jc2 = jpk.PagedKVCache(*pool_j, jc.page_tables, jc.lengths)
    n = _build.plain_dispatches["flash_decode_paged"]
    out_t, pool_t = tfl.mha_paged(
        torch_bf16(q), tc, layer, torch.from_numpy(pos),
        torch.from_numpy(kv_lens), scale=scale,
        extra_kv=(torch_bf16(kn), torch_bf16(vn)), fused_append=True)
    assert _build.plain_dispatches["flash_decode_paged"] == n + 1
    assert pool_t[0] is tc.k_pages
    _assert_pools_equal(tc, jc2, before)
    live = [0, 2]
    _close(out_t[live], out_j[np.asarray(live)], 2)


def test_mha_paged_decode_fused_page16_matches_append_and_xla():
    """Page size 16 (the JAX entry leaves it to XLA): the fused append
    equals JAX's `append_decode` of the live slots, and the output agrees
    with the JAX float32 route over the appended pool, whose newest column
    holds the stored int8 row where the kernel reads the unquantized one
    (the tolerance takes that quantization step too)."""
    jc, tc, q, kn, vn, pos, kv_lens = _decode_case(16, seed=12)
    assert jfl.mha_paged(q, jc, 0, jnp.asarray(pos), jnp.asarray(kv_lens),
                         scale=1.0, extra_kv=(kn, vn),
                         fused_append=True) is None
    scale = 1.0 / math.sqrt(D)
    layer = 0
    live = np.array([True, False, True])
    jc2 = jpk.append_decode(jc, layer, kn, vn,
                            jnp.asarray(np.maximum(kv_lens - 1, 0)[:, None]),
                            active=jnp.asarray(live))
    out_t, _ = tfl.mha_paged(
        torch_bf16(q), tc, layer, torch.from_numpy(pos),
        torch.from_numpy(kv_lens), scale=scale,
        extra_kv=(torch_bf16(kn), torch_bf16(vn)), fused_append=True)
    _assert_pools_equal(tc, jc2)
    ref = jat.attention_cache(q, jc2, layer, jnp.asarray(pos),
                              jnp.asarray(kv_lens), scale=scale,
                              use_flash=False)
    _close(out_t[live], ref[live], 16)


def _prefill_case(ps, seed):
    n_blocks, n_pages = 256 // ps, 3 * (256 // ps) + 2
    jc, tc, rng = _pools(ps, n_blocks, n_pages, seed)
    s = n_blocks * ps
    t = 40
    ar = np.arange(t)
    # slot 0: 30 real rows + padding on the trash position; slot 1: a
    # spectator with nothing stored (every row masked); slot 2: a chunk at
    # offset ps - 10, across a page boundary, over its earlier rows
    kv_lens = np.array([30, 0, ps - 10 + t], np.int32)
    pos = np.stack([np.where(ar < 30, ar, s - 1), ar, ps - 10 + ar]
                   ).astype(np.int32)
    q = jax_bf16(rng.standard_normal((B, t, H, D)).astype(np.float32))
    return jc, tc, q, pos, kv_lens


def test_mha_paged_prefill_matches_pallas_kernel():
    jc, tc, q, pos, kv_lens = _prefill_case(128, seed=13)
    scale = 1.0 / math.sqrt(D)
    out_j = jfl.mha_paged(q, jc, 1, jnp.asarray(pos), jnp.asarray(kv_lens),
                          scale=scale)
    n = _build.plain_dispatches["flash_prefill_paged"]
    out_t = tfl.mha_paged(torch_bf16(q), tc, 1, torch.from_numpy(pos),
                          torch.from_numpy(kv_lens), scale=scale)
    assert _build.plain_dispatches["flash_prefill_paged"] == n + 1
    got, want = _close(out_t, out_j, 2)
    assert np.all(got[1] == 0) and np.all(want[1] == 0)


def test_mha_paged_prefill_page16_matches_xla_route():
    jc, tc, q, pos, kv_lens = _prefill_case(16, seed=14)
    scale = 1.0 / math.sqrt(D)
    want = jat.attention_cache(q, jc, 0, jnp.asarray(pos),
                               jnp.asarray(kv_lens), scale=scale)
    got = tat.attention_cache(torch_bf16(q), tc, 0, torch.from_numpy(pos),
                              torch.from_numpy(kv_lens), scale=scale)
    rows = np.array([0, 2])
    _close(got[rows], want[rows], 8)


def test_paged_reference_route_and_contiguous_equivalence():
    """`use_flash=False` over the pool is the float32 reference over the
    gathered layer, and the plain paged versions equal the contiguous plain
    versions bit for bit over the same logical contents."""
    jc, tc, q, pos, kv_lens = _prefill_case(16, seed=15)
    qt, post, lens = (torch_bf16(q), torch.from_numpy(pos),
                      torch.from_numpy(kv_lens))
    scale = 1.0 / math.sqrt(D)
    ref_t = tat.attention_cache(qt, tc, 1, post, lens, scale=scale,
                                use_flash=False)
    ref_j = jat.attention_cache(q, jc, 1, jnp.asarray(pos),
                                jnp.asarray(kv_lens), scale=scale,
                                use_flash=False)
    _close(ref_t[[0, 2]], ref_j[np.array([0, 2])], 2)
    codes = [a[None] for a in tpk.gather_layer_codes(
        tc.k_pages, tc.v_pages, tc.k_scale, tc.v_scale, tc.page_tables, 1)]
    assert torch.equal(tfl.mha_paged(qt, tc, 1, post, lens, scale=scale),
                       tfl.mha(qt, *codes, post, lens, scale=scale, layer=0))


def test_paged_kernel_checks_refuse_what_the_kernels_cannot_index():
    """The checks before a paged launch (pure Python, exercised on CPU
    tensors): a page size that is not a multiple of 16, tables of another
    dtype or batch, a layer past L, and a pool on another device raise;
    a CPU tensor never reaches them, a meta tensor does."""
    kp = torch.zeros((L, HKV, 5, 32, 64), dtype=torch.int8)
    ks = torch.zeros((L, HKV, 5, 1, 32), dtype=torch.bfloat16)
    tables = torch.zeros((B, 4), dtype=torch.int32)
    q = torch.zeros((B, 4, H, 64), dtype=torch.bfloat16)
    pos = torch.zeros((B, 4), dtype=torch.int32)
    lens = torch.ones((B,), dtype=torch.int32)
    tfl._check_pool(kp, kp, ks, ks, tables, 1, pos, lens, q)
    kp8 = torch.zeros((L, HKV, 5, 8, 64), dtype=torch.int8)
    ks8 = torch.zeros((L, HKV, 5, 1, 8), dtype=torch.bfloat16)
    bad = [dict(kp=kp8, ks=ks8), dict(tables=tables.long()),
           dict(tables=tables[:2]), dict(layer=2),
           dict(kp=kp.to("meta"))]
    for kw in bad:
        a = dict(kp=kp, ks=ks, tables=tables, layer=1) | kw
        with pytest.raises(ValueError, match="paged attention kernels"):
            tfl._check_pool(a["kp"], a["kp"], a["ks"], a["ks"], a["tables"],
                            a["layer"], pos, lens, q)
    with pytest.raises(ValueError, match="page size 8"):
        tfl._check_pool(kp8, kp8, ks8, ks8, tables, 1, pos, lens, q)
    meta = tpk.PagedKVCache(*(a.to("meta") for a in (kp, kp, ks, ks, tables,
                                                     lens)))
    before = dict(_build.plain_dispatches)
    for t, kw in ((4, {}), (1, dict(fused_append=True))):
        qm = torch.zeros((B, t, H, D), dtype=torch.bfloat16, device="meta")
        kn = torch.zeros((B, 1, HKV, D), dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError):
            tfl.mha_paged(qm, meta, 1, pos[:, :t].to("meta"),
                          lens.to("meta"), scale=1.0,
                          extra_kv=(kn, kn) if t == 1 else None, **kw)
        with pytest.raises(ValueError):
            tat.attention_cache(qm, meta, 1, pos[:, :t].to("meta"),
                                lens.to("meta"), use_flash=False)
    assert dict(_build.plain_dispatches) == before
