"""Kernels B and 10 (`csrc/flash_decode.cuh`) as the card runs them, emulated
in numpy on the CPU: no kernel runs here.

* The walk: the grid of `flash.split_columns` splits per (slot, KV head),
  each split's column range, its block steps (the instance's NW warps, 16
  columns each), the online softmax (P = 2^(s log2(e) - m log2(e))) with
  `bf16(P * v_scale)` formed one step late, against the block's running
  max through the next step, and the splits merged one by one in split
  order, from the seed column (the unquantized current k / v), against the
  running max.  Its output is held
  against the JAX package's `_mha_kernel_hblk` (through `mha` / `mha_paged`
  in interpret mode) within 4 bf16 ulps of the row's largest output, the
  tolerance the card's checks use (`chip_smoke.compare(got, want, 4,
  per_row=True)`): int8 with the extra column and the fused append (bf16
  and float32 scales), bf16, float32, ALiBi, the softcap at n_rep 6,
  non-causal, the int8 score dot at t = 1 and over t = 2 and 4 tokens per
  slot, the masked head dim 72, and the pool at page sizes 16 and 128
  (every step's 16 rows resolved through the slot's table, within one
  page).  The appended cache equals the JAX kernel's bit for bit.
* The chunking: every column below S in exactly one split, splits of whole
  tiles, and at least SPLIT_WAVES waves of the SMs where S allows.
* The sources: both products are MMA instructions and the old
  `fmaf(ps[r][j], ...)` loop is gone, the ring is fed by cp.async, one
  kernel launch per call, and the C entries keep the argument counts that
  the wrappers bind.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_speed_tpu.ops import flash as jfl
from neural_speed_tpu.ops import paged_kv as jpk
from neural_speed_tpu_torch.ops import flash as tfl

from tests.torch_port_util import bf16_to_f32, jax_bf16, to_numpy

torch.set_num_threads(1)
ULP = 2.0 ** -8
FLT_MAX = np.float32(np.finfo(np.float32).max)
LOG2E = np.float32(1.4426950408889634)
CSRC = Path(tfl.__file__).resolve().parent.parent / "csrc"
STEP = tfl.DECODE_STEP


def _chunking(b: int, hkv: int, s: int, n_sm: int) -> tuple:
    """(chunk, splits) of kernels B and 10, as decode_cuda asks for them."""
    return tfl.split_columns(b, hkv, s, n_sm, tfl.DECODE_TILE,
                             tfl.DECODE_MAX_SPLITS)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to bf16 (nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _f32(a):
    """A JAX array as float32 numpy (bf16 and int8 exactly)."""
    if a is None:
        return None
    if a.dtype == jnp.bfloat16:
        return bf16_to_f32(to_numpy(a))
    return np.asarray(a).astype(np.float32)


def _warps(elem_bytes: int, d: int) -> int:
    """Warps of a block (the instance's `Ring::kWarps`): 4, or 2 where two
    ring stages of four warps would not fit in ~200 KB (float32 at 256)."""
    di = tfl.instance_dim(d)
    row = -(-di * elem_bytes // 16) * 16
    while row % 64 not in (16, 48):
        row += 16
    scales = 16 * 4 if elem_bytes == 1 else 0           # at most
    stage = 2 * 16 * row + 2 * scales
    return 2 if 2 * 4 * stage > 200 * 1024 else 4


def _q_codes(qr: np.ndarray):
    """The int8 score dot's q rows: codes and the per-row scale."""
    amax = np.abs(qr).max(-1, keepdims=True).astype(np.float32)
    sc = (np.maximum(amax, np.float32(1e-6)) / np.float32(127)).astype(
        np.float32)
    return np.clip(np.rint(qr / sc), -127, 127).astype(np.float32), sc[:, 0]


def walk(q, fetch, s, pos, kv_lens, scale, *, hkv, extra=None, causal=True,
         slopes=None, softcap=0.0, qk=False, out_f32=False, elem_bytes=1,
         n_sm=132, seen=None):
    """Kernel B's arithmetic in its order.  q [B, t, H, D] (rounded to bf16
    here); fetch(b, hk, cs) -> (k, v, ks, vs) of the 16 columns cs.. of a
    step as the kernel reads them (float32: int8 codes, bf16 values,
    float32 values rounded to bf16; scales float32 or None); pos [B] (t = 1)
    or [B, t]; kv_lens [B]; extra: (k_new, v_new) float32 [B, Hkv, D] or
    None.  `seen` (a list) collects every (slot, KV head, split, warp,
    step) walked."""
    b_, t, h_, d = q.shape
    n_rep = h_ // hkv
    nr = t * n_rep
    qb = _bf16(q)
    out = np.zeros(q.shape, np.float32)
    chunk, splits = _chunking(b_, hkv, s, n_sm)
    nw = _warps(elem_bytes, d)
    pos2 = pos.reshape(b_, -1)
    for b in range(b_):
        kvl = int(kv_lens[b])
        if t == 1:
            p = int(pos2[b, 0])
            kvl_c = kvl - (1 if extra is not None and p == kvl - 1 else 0)
            c_end = min(kvl_c, (p if causal else kvl) + 1, s)
            r_end = np.full(nr, c_end)
            r_pos = np.full(nr, p)
        else:
            r_pos = np.array([pos2[b, r % t] for r in range(nr)])
            r_end = np.array([min(min(kvl, pr + 1) if causal else kvl, s)
                              for pr in r_pos])
            c_end = int(r_end.max())
        n_live = -(-c_end // chunk) if c_end > 0 else 1
        for hk in range(hkv):
            heads = [hk * n_rep + r // t for r in range(nr)]
            qr = np.stack([qb[b, r % t, heads[r]] for r in range(nr)])
            codes, qsc = _q_codes(qr) if qk else (None, None)
            slope = (np.array([slopes[x] for x in heads], np.float32)
                     if slopes is not None else None)
            parts = []
            for split in range(n_live):
                c0, c1 = split * chunk, min(split * chunk + chunk, c_end)
                # a block step: the NW warps' 16 columns each; a step's P is
                # formed one step later, against the block's running max
                # through the next step
                m = np.full(nr, -FLT_MAX, np.float32)
                l = np.zeros(nr, np.float32)
                acc = np.zeros((nr, d), np.float32)
                prev = None
                for bs in list(range(c0, c1, STEP * nw)) + [None]:
                    cur = None
                    mx = np.full(nr, -FLT_MAX, np.float32)
                    if bs is not None:
                        got = [fetch(b, hk, cs)
                               for cs in range(bs, bs + STEP * nw, STEP)]
                        if seen is not None:
                            seen.extend((b, hk, split, w, bs + STEP * w)
                                        for w in range(nw)
                                        if bs + STEP * w < c1)
                        kk = np.concatenate([g[0] for g in got])
                        vv = np.concatenate([g[1] for g in got])
                        ks = None if got[0][2] is None else np.concatenate(
                            [g[2] for g in got])
                        vs = None if got[0][3] is None else np.concatenate(
                            [g[3] for g in got])
                        cols = bs + np.arange(STEP * nw)
                        if qk:
                            sc = ((codes @ kk.T) * qsc[:, None]).astype(
                                np.float32)
                        else:
                            sc = (qr @ kk.T).astype(np.float32)
                        x = (sc * ks[None] * np.float32(scale) if ks is not
                             None else sc * np.float32(scale)).astype(
                                 np.float32)
                        if softcap:
                            cap = np.float32(softcap)
                            x = (cap * np.tanh(x / cap)).astype(np.float32)
                        if slope is not None:
                            dist = (cols[None].astype(np.float32)
                                    - r_pos[:, None].astype(np.float32))
                            x = (x + (slope[:, None] * dist).astype(
                                np.float32)).astype(np.float32)
                        valid = ((cols[None] < c1)
                                 & (cols[None] < r_end[:, None]))
                        mx = np.where(valid, x, -FLT_MAX).max(1)
                        cur = (x, valid, vs, vv)
                    mn = np.maximum(m, mx)
                    with np.errstate(over="ignore", invalid="ignore"):
                        alpha = np.exp2((m - mn) * LOG2E).astype(np.float32)
                        ms = (mn * LOG2E).astype(np.float32)
                        if prev is not None:
                            px, pvalid, pvs, pvv = prev
                            pr = np.where(pvalid, np.exp2(
                                (px * LOG2E - ms[:, None]).astype(
                                    np.float32)), 0).astype(np.float32)
                    l = (alpha * l).astype(np.float32)
                    acc = (acc * alpha[:, None]).astype(np.float32)
                    if prev is not None:
                        l = (l + pr.sum(1, dtype=np.float32)).astype(
                            np.float32)
                        pw = _bf16(pr * pvs[None] if pvs is not None else pr)
                        acc = (acc + pw @ pvv).astype(np.float32)
                    m = mn
                    prev = cur
                parts.append((m, l, acc))
            # the last block: the seed column, then the splits in split
            # order against the running max
            valid0 = (extra is not None and t == 1 and p == kvl - 1
                      and p >= 0)
            m = np.full(nr, -FLT_MAX, np.float32)
            l = np.zeros(nr, np.float32)
            acc = np.zeros((nr, d), np.float32)
            if valid0:
                s0 = ((qr @ extra[0][b, hk]) * np.float32(scale)).astype(
                    np.float32)
                if softcap:
                    cap = np.float32(softcap)
                    s0 = (cap * np.tanh(s0 / cap)).astype(np.float32)
                m, l = s0, np.ones(nr, np.float32)
                acc = np.repeat(extra[1][b, hk][None], nr, 0)
            for pm, pl, pa in parts:
                mn = np.maximum(m, pm)
                so = np.exp(m - mn).astype(np.float32)
                si = np.exp(pm - mn).astype(np.float32)
                l = (l * so + pl * si).astype(np.float32)
                acc = (acc * so[:, None] + pa * si[:, None]).astype(np.float32)
                m = mn
            with np.errstate(divide="ignore"):
                inv = np.where(l == 0, 0, np.float32(1) / l).astype(np.float32)
            o = acc * inv[:, None]
            o = o if out_f32 else _bf16(o)
            for r in range(nr):
                out[b, r % t, heads[r]] = o[r]
    return out


def _append(x: np.ndarray, scale_dtype):
    """The fused append's quantization of one row (float32 [D])."""
    amax = np.maximum(np.abs(x).max(), np.float32(1e-8)).astype(np.float32)
    sc = (amax / np.float32(127)).astype(np.float32)
    codes = np.clip(np.rint(x / sc), -127, 127).astype(np.int8)
    return codes, (sc if scale_dtype == "f32" else _bf16(sc))


def _draw(rng, kv, shape):
    if kv.startswith("int8"):
        return jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
    x = rng.standard_normal(shape).astype(np.float32)
    return jax_bf16(x) if kv == "bf16" else jnp.asarray(x)


def _scales(rng, kv, shape):
    if not kv.startswith("int8"):
        return None
    x = rng.uniform(0.5, 1.5, shape).astype(np.float32) * 0.02
    return jnp.asarray(x) if kv == "int8f32" else jax_bf16(x)


def _reads(a):
    """Cache rows as the kernel reads them (float32 rounded to bf16)."""
    if a is None:
        return None
    x = _f32(a)
    return _bf16(x) if a.dtype == jnp.float32 and a.ndim == 5 else x


# (K/V, D, H, Hkv, t, kv_lens, extra column + fused append, causal, ALiBi,
#  softcap, int8 dot, SMs): the slots' lengths are ragged, the last slot a
# spectator parked at S - 1 when t = 1; SMs = 2 makes few long splits (a
# warp walks several steps), 132 many short ones.
CASES = [
    ("int8", 128, 8, 2, 1, [500, 300, 37, 200], True, True, False, 0.0,
     False, 132),
    ("int8", 128, 8, 2, 1, [500, 300, 37, 200], True, True, False, 0.0,
     False, 2),
    ("int8f32", 128, 8, 2, 1, [480, 129, 200], True, True, False, 0.0, False,
     132),
    ("bf16", 128, 8, 2, 1, [500, 17, 200], False, True, False, 0.0, False, 2),
    ("f32", 80, 8, 2, 1, [500, 250, 200], False, True, False, 0.0, False, 132),
    ("int8", 128, 8, 2, 1, [500, 300, 200], True, True, True, 0.0, False, 2),
    ("int8", 128, 12, 2, 1, [500, 300, 200], True, True, False, 30.0, False,
     132),
    ("f32", 64, 4, 4, 1, [500, 450], False, False, False, 0.0, False, 132),
    ("int8", 128, 8, 2, 1, [500, 300, 200], True, True, False, 0.0, True, 2),
    ("int8", 128, 4, 2, 2, [500, 300, 100], False, True, False, 0.0, True, 2),
    ("int8", 128, 4, 2, 4, [500, 300, 100], False, True, False, 0.0, True,
     132),
    ("int8", 72, 8, 2, 1, [500, 300, 200], True, True, False, 0.0, False, 2),
]


def _inputs(kv, d, h, hkv, t, lens, extra, seed):
    rng = np.random.default_rng(seed)
    b, s = len(lens), 512
    k = _draw(rng, kv, (2, b, hkv, s, d))
    v = _draw(rng, kv, (2, b, hkv, s, d))
    ks, vs = (_scales(rng, kv, (2, b, hkv, s)) for _ in range(2))
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    kv_lens = np.array(lens, np.int32)
    if t == 1:
        pos = (kv_lens - 1)[:, None].copy()
        pos[-1] = s - 1                       # a spectator
    else:
        # t verify rows ending at kv_len - 1; the last slot's second half
        # padded at s - 1
        pos = (kv_lens[:, None] - t + np.arange(t)[None]).astype(np.int32)
        pos[-1, t // 2:] = s - 1
    kn = vn = None
    if extra:
        kn, vn = (jax_bf16(rng.standard_normal((b, 1, hkv, d)).astype(
            np.float32)) for _ in range(2))
    return q, k, v, ks, vs, pos.astype(np.int32), kv_lens, kn, vn, s


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_walk_matches_jax(case, monkeypatch):
    (kv, d, h, hkv, t, lens, extra, causal, alibi, softcap, qk,
     n_sm) = case
    if qk:
        jax.clear_caches()
        monkeypatch.setattr(jfl, "FLASH_INT8_DOT", True)
    q, k, v, ks, vs, pos, kv_lens, kn, vn, s = _inputs(
        kv, d, h, hkv, t, lens, extra, 31 + sum(lens))
    if softcap:       # scores of a few units against the cap, where it bites
        q = q * np.float32(2.5)
    if qk:            # one element 30x the rest: the int8 scale is set by it
        q[..., 0] = 60.0
    qj = jax_bf16(q)
    slopes = (np.float32(2.0) ** -np.arange(1, h + 1, dtype=np.float32)
              if alibi else None)
    scale = 1.0 / math.sqrt(d)
    kw = dict(scale=scale, layer=1, causal=causal, logit_softcap=softcap,
              alibi=None if slopes is None else jnp.asarray(slopes))
    jpos = jnp.asarray(pos)
    if extra:
        want, cache_j = jfl.mha(qj, k, v, ks, vs, jpos, jnp.asarray(kv_lens),
                                extra_kv=(kn, vn), fused_append=True, **kw)
    else:
        want = jfl.mha(qj, k, v, ks, vs, jpos, jnp.asarray(kv_lens), **kw)
    if qk:
        jax.clear_caches()
    assert want is not None
    want = _f32(want)
    kr, vr, ksr, vsr = (None if a is None else _reads(a)[1]
                        for a in (k, v, ks, vs))

    def fetch(b, hk, cs):
        sl = slice(cs, cs + STEP)
        return (kr[b, hk, sl], vr[b, hk, sl],
                None if ksr is None else ksr[b, hk, sl],
                None if vsr is None else vsr[b, hk, sl])

    ext = None if not extra else (_f32(kn)[:, 0], _f32(vn)[:, 0])
    elem = {"int8": 1, "int8f32": 1, "bf16": 2, "f32": 4}[kv]
    seen = []
    got = walk(_f32(qj), fetch, s, pos if t > 1 else pos[:, 0], kv_lens,
               scale, hkv=hkv, extra=ext, causal=causal, slopes=slopes,
               softcap=softcap, qk=qk, elem_bytes=elem, n_sm=n_sm, seen=seen)
    tol = 4 * ULP * np.abs(want).max(-1, keepdims=True) + 1e-6
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    np.testing.assert_array_equal(got, _bf16(got))   # a bf16 output
    # every live column is walked once per (slot, KV head)
    steps = {(b, hk, cs) for b, hk, _, _, cs in seen}
    assert len(steps) == len(seen)
    if extra:        # the fused append, bit for bit
        live = pos[:, 0] == kv_lens - 1
        sdt = "f32" if kv == "int8f32" else "bf16"
        for key, new, cj in (("k", kn, cache_j[0]), ("v", vn, cache_j[1])):
            sc_j = _f32(cache_j[2 if key == "k" else 3])
            codes_j = np.asarray(cj)
            orig = np.asarray(k if key == "k" else v)
            for b in range(len(lens)):
                if not live[b]:
                    np.testing.assert_array_equal(codes_j[1, b], orig[1, b])
                    continue
                row = int(kv_lens[b]) - 1
                for hk in range(hkv):
                    codes, sc = _append(_f32(new)[b, 0, hk], sdt)
                    np.testing.assert_array_equal(codes_j[1, b, hk, row],
                                                  codes)
                    assert sc_j[1, b, hk, row] == sc


def _pool(rng, k, v, ks, vs, ps):
    """The contiguous layer's rows as a shuffled page pool (JAX's layout)
    with every page but the trash page in a random order."""
    _, b, hkv, s, d = k.shape
    nb = s // ps
    n_pages = b * nb + 1
    table = rng.permutation(n_pages - 1).reshape(b, nb).astype(np.int32)

    def scatter(a, scales=False):
        if a is None:
            return None
        x = np.asarray(a)
        shape = (x.shape[0], hkv, n_pages, 1, ps) if scales else (
            x.shape[0], hkv, n_pages, ps, d)
        pool = np.zeros(shape, x.dtype)
        for slot in range(b):
            for j in range(nb):
                rows = x[:, slot, :, j * ps:(j + 1) * ps]
                if scales:
                    pool[:, :, table[slot, j], 0] = rows
                else:
                    pool[:, :, table[slot, j]] = rows
        return jnp.asarray(pool)

    return (scatter(k), scatter(v), scatter(ks, True), scatter(vs, True),
            table)


@pytest.mark.parametrize("ps", [16, 128])
def test_paged_walk_matches_jax(ps):
    """The pool: each step's 16 rows resolved through the slot's table lie
    within one page and are the gathered layer's, and the walk over them
    is held against JAX (`mha_paged` at page size 128; at 16, where the
    JAX entry runs XLA, `mha` over the same rows: the same function)."""
    rng = np.random.default_rng(ps)
    lens = [500, 300, 37, 200]
    q, k, v, ks, vs, pos, kv_lens, kn, vn, s = _inputs(
        "int8", 128, 8, 2, 1, lens, True, 5 + ps)
    kp, vp, ksp, vsp, table = _pool(rng, k, v, ks, vs, ps)
    qj = jax_bf16(q)
    scale = 1.0 / math.sqrt(128)
    kw = dict(scale=scale, extra_kv=(kn, vn), fused_append=True)
    if ps % 128 == 0:
        cache = jpk.PagedKVCache(kp, vp, ksp, vsp, jnp.asarray(table),
                                 jnp.zeros((len(lens),), jnp.int32))
        want, _ = jfl.mha_paged(qj, cache, 1, jnp.asarray(pos),
                                jnp.asarray(kv_lens), **kw)
    else:
        want, _ = jfl.mha(qj, k, v, ks, vs, jnp.asarray(pos),
                          jnp.asarray(kv_lens), layer=1, **kw)
    want = _f32(want)
    flat = [np.asarray(_f32(a))[1].reshape(2, -1, *a.shape[4:])
            if a is not None else None for a in (kp, vp)]
    sflat = [np.asarray(_f32(a))[1].reshape(2, -1) for a in (ksp, vsp)]
    kr = _f32(k)[1]

    def fetch(b, hk, cs):
        page = int(table[b, cs // ps])
        assert cs % ps + STEP <= ps                   # within one page
        row = page * ps + cs % ps
        rows = slice(row, row + STEP)
        np.testing.assert_array_equal(flat[0][hk, rows],
                                      kr[b, hk, cs:cs + STEP])
        return (flat[0][hk, rows], flat[1][hk, rows], sflat[0][hk, rows],
                sflat[1][hk, rows])

    got = walk(_f32(qj), fetch, s, pos[:, 0], kv_lens, scale, hkv=2,
               extra=(_f32(kn)[:, 0], _f32(vn)[:, 0]), n_sm=2)
    tol = 4 * ULP * np.abs(want).max(-1, keepdims=True) + 1e-6
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


@pytest.mark.parametrize("b,hkv,s", [(1, 8, 2048), (4, 8, 2048),
                                     (4, 32, 2048), (1, 32, 448),
                                     (4, 20, 448), (1, 1, 64), (2, 4, 30),
                                     (1, 8, 65536)])
@pytest.mark.parametrize("n_sm", [132, 8])
def test_chunking_covers_columns_in_whole_tiles(b, hkv, s, n_sm):
    chunk, splits = _chunking(b, hkv, s, n_sm)
    assert chunk % tfl.DECODE_TILE == 0 and chunk > 0
    assert splits <= tfl.DECODE_MAX_SPLITS
    hits = np.zeros(s, np.int32)
    for i in range(splits):
        hits[i * chunk:min(i * chunk + chunk, s)] += 1
    assert np.all(hits == 1) and (splits - 1) * chunk < s
    tiles = -(-s // tfl.DECODE_TILE)
    want = -(-tfl.SPLIT_WAVES * n_sm // (b * hkv))
    if tiles >= want and want <= tfl.DECODE_MAX_SPLITS:
        assert b * hkv * splits >= tfl.SPLIT_WAVES * n_sm


def _source() -> str:
    return (CSRC / "flash_decode.cuh").read_text()


def test_sources_run_both_products_on_the_tensor_cores():
    src = _source()
    assert "fmaf(ps[r][j]" not in src and "score_chunk" not in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
    assert "movmatrix.sync.aligned.m8n8.trans.b16" in src
    assert "cp.async.cg.shared.global" in src and "cp.async.wait_group" in src
    assert "flash_decode_combine" not in src
    assert src.count("<<<") == 1              # one launch per call
    assert "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32" in src
    assert "atom.add.acq_rel.gpu.global.s32" in src   # the last block merges
    for d in tfl.HEAD_DIMS:
        for name, paged in (("flash_decode", 0), ("flash_decode_paged", 1)):
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
    wrappers = Path(tfl.__file__).read_text()
    for name in ("nst_flash_decode", "nst_flash_decode_paged"):
        bound = re.search(r'"' + name + r'", (\d+), (\d+), (\d+)\)',
                          wrappers)
        assert bound is not None
        assert _entry_counts(src, name) == tuple(map(int, bound.groups()))


def test_constants_match_the_source():
    src = _source()
    const = lambda n: re.search(r"constexpr int " + n + r" = ([^;]+);",
                                src).group(1)
    assert int(const("STEP")) == tfl.DECODE_STEP
    assert int(const("TILE")) == tfl.DECODE_TILE
    assert int(const("MAX_SPLITS")) == tfl.DECODE_MAX_SPLITS
    assert int(const("MAX_ROWS")) == 8
    assert "kWarps = 2 * 4 * kStage > 200 * 1024 ? 2 : 4" in src
    assert [_warps(e, d) for e in (1, 2, 4)
            for d in (128, 256)] == [4, 4, 4, 4, 4, 2]
