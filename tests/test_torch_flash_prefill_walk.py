"""Kernels C and 9 (`csrc/flash_prefill.cuh`) as the card runs them, emulated
in numpy on the CPU: no kernel runs here.

* The walk: the blocks of `flash.PREFILL_TILES` rows issued heaviest first,
  each block's column range (kv_len and, when causal, its last position),
  which tiles of a consumer warpgroup's 64 rows take the per-element mask
  (a tile that every row sees whole takes none, so the mask must then be
  all true), the online softmax at the kernel's tile width with its exp2
  form, and `bf16(P * v_scale)` against the running max.  Its output is
  held against the JAX package's `_mha_kernel` in interpret mode within 4
  bf16 ulps of the row's largest output, the tolerance the card's checks
  use (`chip_smoke.compare(got, want, 4, per_row=True)`).
* The paged walk: the producer's copies (`run` = gcd(page size, 64) rows,
  resolved through the slot's table) load exactly the contiguous walk's
  tiles: every column once, no row of another slot's pages, no copy across
  a page boundary.
* The swizzle: the transform's 16-byte stores cover every (row, chunk) of
  a tile once, where TMA's 128-byte swizzle would put them.
* The sources: no `nvcuda::wmma` is left, both products are `wgmma`, the
  tiles are fed through mbarrier rings, the C entries keep the argument
  counts that the wrappers bind, and the tile constants equal
  `PREFILL_TILES`; `decode_body`'s routes are unchanged.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.ops import flash as jfl
from neural_speed_tpu_torch.ops import flash as tfl
from neural_speed_tpu_torch.ops import paged_kv as tpk

from tests.torch_port_util import bf16_to_f32, jax_bf16, to_numpy

torch.set_num_threads(1)
ULP = 2.0 ** -8
LOG2E = np.float32(1.4426950408889634)
FLT_MAX = np.float32(np.finfo(np.float32).max)
CSRC = Path(tfl.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to bf16 (nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def walk(q, k, v, ks, vs, pos, kv_lens, scale, *, causal=True, slopes=None,
         softcap=0.0, out_f32=False, seen=None):
    """Kernel C's arithmetic in its order.  q [B, T, H, D] (rounded to bf16
    here); k / v [B, Hkv, S, D] as the kernel reads them (int8 codes as
    floats, float32 values rounded to bf16); ks / vs [B, Hkv, S] float32 or
    None; pos [B, T]; kv_lens [B].  `seen` (a list) collects each block's
    (tile index, columns walked, tiles masked per warpgroup)."""
    b_, t_, h_, d = q.shape
    hkv, s_ = k.shape[1], k.shape[2]
    bt, bc = tfl.prefill_tile(t_, d)
    qb = _bf16(q)
    out = np.zeros(q.shape, np.float32)
    n_row_tiles = -(-t_ // bt)
    order = [(n_row_tiles - 1 - y, x) for y in range(n_row_tiles)
             for x in range(h_ * b_)]                 # heaviest first
    for tile, x in order:
        h, b = x % h_, x // h_
        hk = h // (h_ // hkv)
        rows = tile * bt + np.arange(bt)
        live = rows < t_
        p = np.where(live, pos[b, np.minimum(rows, t_ - 1)], -1)
        lim = p if causal else np.full(bt, np.iinfo(np.int32).max)
        kv_len = int(kv_lens[b])
        c_end = min(kv_len, int(p.max()) + 1, s_) if causal else min(kv_len,
                                                                     s_)
        n_tiles = -(-c_end // bc) if c_end > 0 else 0
        pmin = [int(p[64 * c:64 * c + 64].min()) for c in range(bt // 64)]
        qr = np.where(live[:, None], qb[b, np.minimum(rows, t_ - 1), h], 0)
        m = np.full(bt, -FLT_MAX, np.float32)
        l = np.zeros(bt, np.float32)
        acc = np.zeros((bt, d), np.float32)
        masked = [[] for _ in pmin]
        for i in range(n_tiles):
            c0 = i * bc
            cols = c0 + np.arange(bc)
            sc = qr @ k[b, hk, cols].T
            xs = (sc * ks[b, hk, cols] * np.float32(scale) if ks is not None
                  else sc * np.float32(scale)).astype(np.float32)
            if softcap:
                cap = np.float32(softcap)
                xs = (cap * np.tanh(xs / cap)).astype(np.float32)
            if slopes is not None:
                dist = cols[None].astype(np.float32) - p[:, None].astype(
                    np.float32)
                xs = (xs + (np.float32(slopes[h]) * dist).astype(np.float32)
                      ).astype(np.float32)
            valid = (cols[None] < c_end) & (cols[None] <= lim[:, None])
            for c, pm in enumerate(pmin):
                full = c0 + bc <= c_end and (not causal or c0 + bc - 1 <= pm)
                part = slice(64 * c, 64 * c + 64)
                if full:    # no per-element mask: every row sees the tile
                    assert valid[part].all()
                else:
                    masked[c].append(i)
                    xs[part] = np.where(valid[part], xs[part], -np.inf)
            with np.errstate(over="ignore", invalid="ignore"):
                mn = np.maximum(m, np.maximum(xs.max(1), -FLT_MAX))
                alpha = np.exp2((m - mn) * LOG2E).astype(np.float32)
                ms = np.where(mn == -FLT_MAX, 0, mn * LOG2E).astype(np.float32)
                pr = np.exp2((xs.astype(np.float64) * LOG2E
                              - ms[:, None]).astype(np.float32))
            l = (alpha * l + pr.sum(1, dtype=np.float32)).astype(np.float32)
            pw = _bf16(pr * vs[b, hk, cols] if vs is not None else pr)
            acc = (acc * alpha[:, None] + pw @ v[b, hk, cols]).astype(
                np.float32)
            m = mn
        with np.errstate(divide="ignore"):
            inv = np.where(l == 0, 0, np.float32(1) / l).astype(np.float32)
        o = acc * inv[:, None]
        o = o if out_f32 else _bf16(o)
        out[b, rows[live], h] = o[live]
        if seen is not None:
            seen.append((tile, n_tiles, masked))
    return out


def _draw(rng, kv, shape, std=1.0):
    if kv.startswith("int8"):
        return jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
    x = (rng.standard_normal(shape) * std).astype(np.float32)
    return jax_bf16(x) if kv == "bf16" else jnp.asarray(x)


def _scales(rng, kv, shape):
    if not kv.startswith("int8"):
        return None
    x = rng.uniform(0.5, 1.5, shape).astype(np.float32) * 0.02
    return jnp.asarray(x) if kv == "int8f32" else jax_bf16(x)


def _f32(a):
    """A JAX array as float32 numpy (bf16 and int8 exactly)."""
    if a is None:
        return None
    if a.dtype == jnp.bfloat16:
        return bf16_to_f32(to_numpy(a))
    return np.asarray(a).astype(np.float32)


# (K/V, D, T, kv_lens, causal, ALiBi, softcap, out f32): every K/V type,
# head dim instance and the masked 72; T = 1, 4, 8 (one consumer
# warpgroup), 65 and 1500 (two; one at D = 256); a ragged B = 4 with
# padded rows on the trash position s - 1 and an empty slot; non-causal
# with a float32 output (whisper's encoder); ALiBi; the softcap.
CASES = [
    ("int8", 128, 1500, [1500], True, False, 0.0, False),
    ("int8", 128, 65, [65, 40, 7, 0], True, False, 0.0, False),
    ("int8f32", 64, 8, [8, 3], True, False, 0.0, False),
    ("bf16", 80, 4, [70, 4], True, False, 0.0, False),
    ("f32", 96, 1, [100, 1], True, False, 0.0, False),
    ("bf16", 256, 65, [65, 30], True, False, 0.0, False),
    ("f32", 256, 8, [8], True, False, 0.0, False),
    ("int8", 72, 65, [65, 65], True, False, 0.0, False),
    ("f32", 64, 65, [100, 65], False, False, 0.0, True),
    ("int8", 128, 65, [65, 20], True, True, 0.0, False),
    ("bf16", 128, 65, [65, 65], True, False, 30.0, False),
    ("int8f32", 80, 1500, [1500], True, False, 0.0, False),
]


def _case_inputs(kv, d, t, lens, seed):
    rng = np.random.default_rng(seed)
    b, h, hkv = len(lens), 4, 2
    s = -(-max(t, max(lens)) // 128) * 128
    k = _draw(rng, kv, (1, b, hkv, s, d))
    v = _draw(rng, kv, (1, b, hkv, s, d))
    ks, vs = (_scales(rng, kv, (1, b, hkv, s)) for _ in range(2))
    q = jax_bf16(rng.standard_normal((b, t, h, d)).astype(np.float32))
    kv_lens = np.array(lens, np.int32)
    ar = np.arange(t)[None]
    # prompts at positions 0.. (decode-like calls at the end of the slot),
    # padding rows on the trash position s - 1
    start = np.maximum(kv_lens - t, 0)[:, None]
    pos = np.where(ar < np.minimum(kv_lens, t)[:, None], start + ar, s - 1)
    return q, k, v, ks, vs, pos.astype(np.int32), kv_lens, s


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_walk_matches_jax(case):
    kv, d, t, lens, causal, alibi, softcap, out_f32 = case
    q, k, v, ks, vs, pos, kv_lens, s = _case_inputs(kv, d, t, lens, 17)
    h = q.shape[2]
    slopes = (np.float32(2.0) ** -np.arange(1, h + 1, dtype=np.float32)
              if alibi else None)
    scale = 1.0 / math.sqrt(d)
    want = jfl.mha(q, k, v, ks, vs, jnp.asarray(pos), jnp.asarray(kv_lens),
                   scale=scale, layer=0, causal=causal,
                   alibi=None if slopes is None else jnp.asarray(slopes),
                   logit_softcap=softcap,
                   out_dtype=jnp.float32 if out_f32 else None)
    want = np.asarray(want.astype(jnp.float32))
    rd = lambda a: None if a is None else (
        _bf16(_f32(a)[0]) if a.dtype == jnp.float32 and a.ndim == 5
        else _f32(a)[0])
    seen = []
    got = walk(_f32(q), rd(k), rd(v), rd(ks), rd(vs), pos, kv_lens, scale,
               causal=causal, slopes=slopes, softcap=softcap,
               out_f32=out_f32, seen=seen)
    tol = 4 * ULP * np.abs(want).max(-1, keepdims=True) + 1e-6
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    assert seen and all(n >= 0 for _, n, _ in seen)
    if not out_f32:       # a bf16 output is bf16 values
        np.testing.assert_array_equal(got, _bf16(got))


def test_walk_order_and_masked_tiles():
    """Causal prefill at T = 1500 from position 0: blocks come heaviest
    first, a block walks the tiles up to its last row, and a consumer
    warpgroup masks only the tiles from its diagonal on (those of the
    other warpgroup's rows included), or every tile when it holds rows past
    T (position -1)."""
    q, k, v, ks, vs, pos, kv_lens, s = _case_inputs("int8", 128, 1500,
                                                    [1500], 3)
    seen = []
    one = lambda a: _f32(a)[0][:, :1]         # one KV head, one query head
    walk(_f32(q)[:, :, :1], one(k), one(v), one(ks), one(vs), pos, kv_lens,
         0.1, seen=seen)
    bt, bc = tfl.prefill_tile(1500, 128)
    tiles = [tile for tile, _, _ in seen]
    assert tiles == sorted(tiles, reverse=True) and tiles[0] == 1500 // bt
    for tile, n_tiles, masked in seen:
        last = min(tile * bt + bt, 1500) - 1
        assert n_tiles == last // bc + 1
        for c, m in enumerate(masked):
            lo, hi = tile * bt + 64 * c, tile * bt + 64 * c + 63
            if hi > 1499:      # rows past T (position -1): all masked
                assert m == list(range(n_tiles))
            else:              # from its diagonal to the block's last
                assert m == list(range(lo // bc, n_tiles))


def _run(ps: int) -> int:
    return 64 if ps % 64 == 0 else 32 if ps % 32 == 0 else 16


@pytest.mark.parametrize("ps", [16, 48, 128, 256])
def test_paged_walk_loads_the_contiguous_tiles(ps):
    """The producer's copies over a shuffled pool load, tile by tile, the
    rows of the gathered (contiguous) layer: every column below the slot's
    length once, only rows of the slot's own pages (or, past the table's
    end, its last page: masked), and no copy crosses a page."""
    rng = np.random.default_rng(ps)
    b, hkv, d, nb = 3, 2, 8, 5
    n_pages = b * nb + 1
    table = rng.permutation(n_pages - 1).reshape(b, nb).astype(np.int32)
    pool = rng.integers(-127, 128, (1, hkv, n_pages, ps, d)).astype(np.int8)
    kt = torch.from_numpy(pool)
    gathered = tpk.gather_layer_codes(kt, kt, None, None,
                                      torch.from_numpy(table), 0)[0].numpy()
    bc, run, s = 64, _run(ps), nb * ps
    assert bc % run == 0 and ps % run == 0
    flat = pool.reshape(1, hkv, n_pages * ps, d)
    for slot in range(b):
        kv_len = s - 7 * slot
        n_tiles = -(-kv_len // bc)
        hits = np.zeros(s, np.int32)
        for hk in range(hkv):
            for i in range(n_tiles):
                tile = np.zeros((bc, d), np.int8)
                for r in range(0, bc, run):
                    c = i * bc + r
                    blk = min(c // ps, nb - 1)
                    phys = int(table[slot, blk]) * ps + c % ps
                    assert c % ps + run <= ps            # within one page
                    assert phys // ps in table[slot]      # the slot's page
                    tile[r:r + run] = flat[0, hk, phys:phys + run]
                    if hk == 0:
                        live = np.arange(c, c + run)
                        hits[live[live < s]] += 1
                cols = i * bc + np.arange(bc)
                ok = cols < min(kv_len, s)
                np.testing.assert_array_equal(
                    tile[ok], gathered[slot, hk, cols[ok]])
        assert np.all(hits[:kv_len] == 1)


@pytest.mark.parametrize("di", tfl.HEAD_DIMS)
def test_transform_swizzle_covers_each_chunk_once(di):
    """The transform's stores (`transform_tile`: thread tt of the 128 keeps
    the 16-byte chunk ch = tt % CH of its rows tt // CH, + 128 // CH, ...)
    land where TMA's 128-byte swizzle puts them (address bits 4-6 xor bits
    7-9 within a 1024-byte-aligned tile), each (row, chunk) of the tile
    once."""
    bc = tfl.PREFILL_TILES[di][1]
    dp = -(-di // 64) * 64
    ch_n = dp // 8
    nt = 128                                    # warpgroup 0 transforms
    assert nt % ch_n == 0
    used = np.zeros(bc * dp * 2 // 16, np.int32)
    for tt in range(nt):
        ch, r0 = tt % ch_n, tt // ch_n
        for r in range(r0, bc, nt // ch_n):
            off = ((ch // 8) * (bc * 128) + r * 128
                   + (((ch % 8) << 4) ^ ((r & 7) << 4)))
            plain = (ch // 8) * (bc * 128) + r * 128 + (ch % 8) * 16
            assert off == plain ^ (((plain >> 7) & 7) << 4)
            used[off // 16] += 1
    assert np.all(used == 1)


def _source() -> str:
    return (CSRC / "flash_prefill.cuh").read_text()


def test_sources_run_wgmma_through_mbarrier_rings():
    src = _source()
    assert "nvcuda::wmma" not in src and "wmma::" not in src
    assert "<mma.h>" not in src
    assert "wgmma.mma_async" in src and "WgmmaRS<ON>::mma" in src
    assert "Wgmma<BC>::mma" in src
    assert "cp.async.bulk.tensor.3d" in src and "cp.async.bulk.shared" in src
    assert "bar_wait(&t_full" in src and "bar_wait(&r_full" in src
    for d in tfl.HEAD_DIMS:
        for name, paged in (("flash_prefill", 0), ("flash_prefill_paged", 1)):
            text = (CSRC / f"{name}_d{d}.cu").read_text()
            assert f"#define NST_FLASH_DIM {d}\n" in text
            assert f"#define NST_FLASH_PAGED {paged}\n" in text


def _entry_counts(src: str, name: str) -> tuple:
    sig = re.search(r'extern "C" int ' + name + r"\((.*?)\)", src, re.S)
    params = [p.strip() for p in sig.group(1).split(",")]
    assert params[-1] == "void* stream"
    ptrs = sum("*" in p for p in params[:-1])
    ints = sum(p.startswith("int ") for p in params)
    floats = sum(p.startswith("float ") for p in params)
    assert ptrs + ints + floats == len(params) - 1
    return ptrs, ints, floats


def test_entries_keep_the_bound_argument_counts():
    src = _source()
    wrappers = (Path(tfl.__file__)).read_text()
    for name in ("nst_flash_prefill", "nst_flash_prefill_paged"):
        bound = re.search(r'"' + name + r'", (\d+), (\d+), (\d+)\)',
                          wrappers)
        assert bound is not None
        assert _entry_counts(src, name) == tuple(map(int, bound.groups()))


def test_tile_constants_match_the_source():
    src = _source()
    const = lambda n: re.search(r"constexpr int " + n + r" = ([^;]+);",
                                src).group(1)
    assert const("BC") == "64" and const("FEW_ROWS") == str(
        tfl.PREFILL_FEW_ROWS)
    assert const("MAX_NC") == "DI > 128 ? 1 : 2"
    for di, (rows, cols) in tfl.PREFILL_TILES.items():
        assert (rows, cols) == (64 * (1 if di > 128 else 2), 64)
        assert tfl.prefill_tile(tfl.PREFILL_FEW_ROWS, di) == (64, cols)
        assert tfl.prefill_tile(tfl.PREFILL_FEW_ROWS + 1, di) == (rows, cols)


# decode_body(t, H, Hkv, D, extra, qk, quantized) -> route, as before the
# prefill redesign.
ROUTES = [
    ((1, 32, 32, 128, True, False, True), "B"),
    ((1, 32, 8, 128, False, False, False), "B"),
    ((1, 71, 1, 64, False, False, False), "rows"),
    ((1, 8, 1, 256, False, False, True), "rows"),
    ((1, 12, 3, 128, False, False, True), "rows"),
    ((1, 32, 32, 128, False, False, True), "C"),
    ((2048, 32, 32, 128, False, False, True), "C"),
    ((4, 32, 8, 128, False, False, True), "C"),
    ((4, 32, 32, 128, False, True, True), "B"),
    ((2, 8, 2, 128, False, True, True), "B"),
]


@pytest.mark.parametrize("args,route", ROUTES)
def test_decode_body_routes_unchanged(args, route):
    t, h, hkv, d, extra, qk, quantized = args
    assert tfl.decode_body(t, h, hkv, d, extra=extra, qk=qk,
                           quantized=quantized) == route
