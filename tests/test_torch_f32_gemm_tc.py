"""The float32 GEMM of kernels F, P and P's one-plane INT instances
(`csrc/qmm_fp.cuh`, `tc::gemm_tf32x3_kernel`: float32 x and out, M > 32), on
the CPU: numpy emulations of the device arithmetic (no kernel runs here).

* The split: `cvt.rna.tf32.f32` emulated bit for bit (and held against an
  independent rounding of the significand); for every dequantized weight of
  every format and zero mode (INT1-INT8 with each zero rule, fp8 e4m3 /
  e5m2, the NF4 / FP4 tables) and for float32 x, hi and lo are exact TF32
  operands and hi + lo is v or one float32 ulp of v away (within 2^-23 |v|).
* The walk: the transform warpgroup's reads of the packs as stored (the TMA
  boxes of 32 k' a step over the band-major K) and the consumers' stores
  write every output once and read each packed word once per output tile,
  at M = 33, 100 and 300, g = 32 and 128; the W tile each step builds is the
  dequantized weight at the band-major k' that x's tile holds; each band's
  held scale and zero term is its group's at every row of every step.
* The product: the three TF32 products per k8 step (lo_x hi_w, hi_x lo_w,
  hi_x hi_w), each wgmma's sum truncated into the accumulator as the card's
  tensor cores do (toward zero: `chip_levers.py --acc`), a fresh
  accumulator every 32-k' step added into a float32 total, equals the JAX
  package's `qmatmul_xla` (float32 at M > 32) within F32_ULPS of the
  largest output;
  the same walk with one product (1xTF32) fails that tolerance, and without
  the fold the truncation drifts far beyond the fold's error at K = 4096.
* The source: `gemm_f32_kernel` is gone, both `_f32` GEMM entries bind
  `run_gemm_f32`, which launches the 3xTF32 body.
* The launch: `_fp_launch`, with the entry stubbed, hands the GEMM entry its
  arguments (x band-major) and counts one launch under `..._f32`.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.ops import matmul as jm
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch.ops import matmul as tmm
from neural_speed_tpu_torch.ops.qtypes import plane_widths
from neural_speed_tpu_torch.ops.quantize import dequantize

from tests.test_torch_fp_gemv_route import (PACKS, _bands, _draw, _jax_and_port,
                                            _k_for, _spec, _words)

CSRC = Path(tmm.__file__).resolve().parent.parent / "csrc"
F32 = np.float32
# chip_smoke.py's check_f32_formats: float32 ulps of the largest |output|
F32_ULPS = 256
BK, BM, BN = 32, 128, 128   # the kernel's K step (k'), output tile


# ---------------------------------------------------------------------------
# the device's operations
# ---------------------------------------------------------------------------


def tf32_rna(v) -> np.ndarray:
    """`cvt.rna.tf32.f32`: to TF32's 10-bit mantissa, to nearest, ties away
    from zero (the magnitude's bits rounded; the low 13 bits cleared)."""
    b = np.asarray(v, F32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def split(v):
    """The kernel's pair: hi = rna(v), lo = rna(v - hi) (v - hi exact)."""
    v = np.asarray(v, F32)
    hi = tf32_rna(v)
    return hi, tf32_rna((v - hi).astype(F32))


def rz_f32(v64: np.ndarray) -> np.ndarray:
    """float64 values to float32 toward zero: a wgmma's sum written into the
    accumulator (the card's rounding probe: chip_levers.py --acc)."""
    f = v64.astype(F32)
    over = np.abs(f.astype(np.float64)) > np.abs(v64)
    return np.where(over, np.nextafter(f, F32(0)), f).astype(F32)


def product_3xtf32(xk: np.ndarray, wk: np.ndarray, fold: bool = True,
                   terms: int = 3) -> np.ndarray:
    """xk [M, K'] (band-major) @ wk [K', N] as the consumers form it: per k8
    step three wgmmas (terms = 1: hi_x hi_w alone), each adding its exact
    products to the accumulator and truncating; with `fold`, a fresh
    accumulator every BK k' added into a float32 total (to nearest)."""
    xh, xl = split(xk)
    wh, wl = split(wk)
    m, n = xk.shape[0], wk.shape[1]
    acc = np.zeros((m, n), F32)
    tot = np.zeros((m, n), F32)
    for k8 in range(0, xk.shape[1], 8):
        sl = slice(k8, k8 + 8)
        if fold and k8 % BK == 0:
            acc = np.zeros((m, n), F32)
        pairs = [(xh, wh)] if terms == 1 else [(xl, wh), (xh, wl), (xh, wh)]
        for a, b in pairs:
            exact = a[:, sl].astype(np.float64) @ b[sl].astype(np.float64)
            acc = rz_f32(acc.astype(np.float64) + exact)
        if fold and (k8 + 8) % BK == 0:
            tot = (tot + acc).astype(F32)
    return tot if fold else acc


def _within(got, want) -> float:
    """The largest |got - want| over F32_ULPS float32 ulps of max |want|."""
    want = np.asarray(want, np.float64)
    tol = F32_ULPS * 2.0 ** -23 * np.abs(want).max()
    return float(np.abs(np.asarray(got, np.float64) - want).max() / tol)


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------


def _rna_reference(v) -> np.ndarray:
    """Rounding to 11 significant bits, ties away, through frexp (a second
    way to the same bits)."""
    v64 = np.asarray(v, F32).astype(np.float64)
    m, e = np.frexp(v64)
    s = m * 2048.0
    r = np.sign(s) * np.floor(np.abs(s) + 0.5)
    return (np.ldexp(r / 2048.0, e)).astype(F32)


def test_tf32_rna_is_round_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, 200000, dtype=np.uint64).astype(np.uint32)
    v = bits.view(F32)
    v = v[np.isfinite(v) & (np.abs(v) < 1e38) & (np.abs(v) >= 2.0 ** -126)]
    np.testing.assert_array_equal(tf32_rna(v).view(np.uint32),
                                  _rna_reference(v).view(np.uint32))
    # ties: the half-way point rounds away from zero, either sign
    one = np.array([1.0], F32).view(np.uint32)
    tie = (one + np.uint32(0x1000)).view(F32)
    assert tf32_rna(tie)[0] == np.float32(1.0 + 2.0 ** -10)
    assert tf32_rna(-tie)[0] == np.float32(-(1.0 + 2.0 ** -10))


def _check_split(v: np.ndarray) -> None:
    """hi and lo are exact TF32 operands and hi + lo is v or one float32 ulp
    of v away from it (|v - hi| has up to 12 significant bits, lo keeps 11;
    a dropped last bit is a tie, which rounds away): within 2^-23 |v|, and
    within 2^-24 |v| only where that bit is 0."""
    hi, lo = split(v)
    for t in (hi, lo):   # exact TF32 operands: no bit below the mantissa
        assert (t.view(np.uint32) & np.uint32(0x1FFF) == 0).all()
    v64 = v.astype(np.float64)
    err = np.abs(v64 - hi.astype(np.float64) - lo.astype(np.float64))
    ulp = np.spacing(np.abs(v)).astype(np.float64)
    assert np.isin(err / ulp, (0.0, 1.0)).all()
    assert (err <= 2.0 ** -23 * np.abs(v64)).all()


@pytest.mark.parametrize("pack", PACKS, ids=[p[0] for p in PACKS])
def test_split_of_every_dequantized_weight(pack):
    """Every weight the transform computes (`dequantize` in float32, which
    the CUDA-core GEMV tests hold bit for bit to the device's decode), split
    into the TF32 pair the W tiles hold."""
    k = _k_for(pack, 256)
    qt, _ = _draw(pack, k, 256, seed=7, small=False)
    _check_split(dequantize(qt, torch.float32).numpy().ravel())


def test_split_of_float32_x():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(1 << 18) * 1.37).astype(F32)
    wide = np.ldexp(rng.uniform(1, 2, 1 << 16), rng.integers(-60, 60, 1 << 16))
    _check_split(x)
    _check_split(np.concatenate([wide, -wide]).astype(F32))
    # a TF32 value is its own hi, with lo = 0
    t = tf32_rna(x)
    hi, lo = split(t)
    np.testing.assert_array_equal(hi, t)
    assert (lo == 0).all()


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------


def _band_major_perm(k: int, bands: int) -> np.ndarray:
    """perm with xk = x[:, perm]: `matmul._band_major`, which hands x to the
    GEMM."""
    x = torch.arange(k, dtype=torch.float32)[None]
    return tmm._band_major(x, bands)[0].numpy().astype(np.int64)


def walk(qt, m: int):
    """The kernel over its grid: per block, per step s, the transform's
    reads of the packed words (plane p's box: band blocks jq < q(p), word
    rows s * R .. s * R + R - 1 of each, the block's 128 columns; byte rows:
    rows s * 32 .. + 31) with the k' each weight lands at in the step's W
    tile (k' = row * EF + band), and the consumers' stores (`store_tile`
    of two 64 x 128 accumulators).  Returns the W tile of every k' (k' over
    the whole K, as the band-major x tile holds it: the code's K row), the
    per-word read counts of each plane, and the write count per output."""
    spec = qt.spec
    k, n = qt.shape
    ef = _bands(spec)
    steps = -(-k // BK)
    words = _words(qt)
    reads = [np.zeros(w.shape, np.int64) for w in words]
    written = np.zeros((m, n), np.int64)
    k_of = np.full(steps * BK, -1, np.int64)      # k' -> the code's K row
    byte = tmm._byte_rows(spec)
    widths = (8,) if byte else ((4,) if spec.is_lut else plane_widths(spec.bits))
    kw = k // ef
    for by in range(-(-m // BM)):
        for bx in range(-(-n // BN)):
            cols = np.arange(bx * BN, min(n, (bx + 1) * BN))
            for s in range(steps):
                if byte:
                    rows = np.arange(s * BK, min(k, (s + 1) * BK))
                    # a uint32 word holds 4 columns of one row
                    reads[0][np.ix_(rows, np.unique(cols // 4))] += 1
                    k_of[s * BK + (rows - s * BK)] = rows
                    continue
                r = BK // ef
                for p, wd in enumerate(widths):
                    q = ef * wd // 32
                    for jq in range(q):
                        wr = jq * kw + s * r + np.arange(r)
                        reads[p][np.ix_(wr, cols)] += 1
                for i in range(r):
                    for b in range(ef):
                        k_of[s * BK + i * ef + b] = b * kw + s * r + i
            # the consumers' stores: thread t of warpgroup c, 16 groups of
            # 4 floats (store_tile's float path)
            for c in range(2):
                for t in range(128):
                    w_, l = t // 32, t % 32
                    q, odd = l % 4, (l % 4) & 1
                    r0 = by * BM + 64 * c + 16 * w_ + l // 4 + (8 if odd else 0)
                    for j in range(BN // 8):
                        gn = bx * BN + 8 * j + 2 * (q & 2)
                        if r0 < m and gn < n:
                            written[r0, gn:gn + 4] += 1
    return k_of[:k], reads, written


WALK_PACKS = [p for p in PACKS if p[0] in (
    "nf4", "int1", "int2-asym", "int3", "gptq", "q4_0", "int5-asym", "int6",
    "int7", "q8_0", "int8-asym", "e4m3")]


@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("m", [33, 100, 300])
@pytest.mark.parametrize("pack", WALK_PACKS, ids=[p[0] for p in WALK_PACKS])
def test_walk_covers_every_output_once_and_reads_each_word_once(pack, m, g):
    pack = (pack[0], pack[1], g) + pack[3:]
    k = _k_for(pack, 512)
    n = 264   # a ragged column tile (TMA fills its missing columns with zeros)
    qt, _ = _draw(pack, k, n, seed=m + g, small=True)
    k_of, reads, written = walk(qt, m)
    assert (written == 1).all()
    tiles = -(-m // BM)
    for r in reads:
        assert (r == tiles).all()
    # the W tile at k' holds the weight of K row k_of[k'], and x's tile at
    # k' holds x[:, k_of[k']]: the band-major order of the wrapper
    np.testing.assert_array_equal(k_of, _band_major_perm(k, _bands(qt.spec)))


@pytest.mark.parametrize("g", [8, 16, 32, 128, 256])
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7])
def test_held_group_terms_are_each_rows_group(bits, g):
    """transform_packed's reload at 32 k' a step (R = 32 / EF word rows,
    every band in one thread): the (group, column) term a band holds at row
    i of step s is that of its K row's group, with a load only where a
    band's group starts (next_any)."""
    ef = 32 // (bits & -bits)
    r = BK // ef
    k = max(g, 8 * ef) * 4
    kw, steps = k // ef, k // BK
    held, loads = [None] * ef, 0
    nxt_any = 0

    def reload(s):
        nonlocal nxt_any, loads
        rb = s * r
        if rb < nxt_any:
            return
        nxt = 1 << 30
        for b in range(ef):
            grp = (b * kw + rb) // g
            if s == 0 or b * kw + rb - grp * g < r:
                held[b] = grp
                loads += 1
            nxt = min(nxt, (grp + 1) * g - b * kw)
        nxt_any = nxt

    reload(0)
    for s in range(steps):
        for i in range(r):
            for b in range(ef):
                assert held[b] == (b * kw + s * r + i) // g
        if s + 1 < steps:
            reload(s + 1)
    # one load per band and group it enters, never one per step
    assert loads == sum(len({(b * kw + rr) // g for rr in range(kw)})
                        for b in range(ef))


# ---------------------------------------------------------------------------
# the product
# ---------------------------------------------------------------------------

XLA_PACKS = [p for p in PACKS if p[0] in (
    "nf4", "int1", "q2_k", "int3", "gptq", "q4_0", "int5-asym", "int7",
    "q8_0", "int8-off", "e4m3", "e5m2")]


@pytest.mark.parametrize("m", [33, 100])
@pytest.mark.parametrize("pack", XLA_PACKS, ids=[p[0] for p in XLA_PACKS])
def test_product_matches_qmatmul_xla(pack, m):
    """The walk's product in 3xTF32 with the fold, on float32 x, against the
    JAX package's `qmatmul_xla` in float32 (M > 32); 1xTF32 misses the same
    tolerance."""
    k, n = _k_for(pack, 512), 136
    jqt, qt = _jax_and_port(pack, k, n, seed=m + 3)
    rng = np.random.default_rng(m)
    x = (rng.standard_normal((m, k)) * 1.37).astype(F32)
    want = np.asarray(jm.qmatmul_xla(jnp.asarray(x), jqt), F32)
    assert want.dtype == np.float32 and want.shape == (m, n)
    w = dequantize(qt, torch.float32).numpy()
    perm = _band_major_perm(k, _bands(qt.spec))
    xk, wk = x[:, perm], w[perm]
    assert _within(product_3xtf32(xk, wk), want) <= 0.25
    assert _within(product_3xtf32(xk, wk, terms=1), want) > 1.0


def test_fold_removes_the_truncation_drift():
    """At Llama's K = 4096 the truncating accumulator, carried over the
    whole K, drifts toward zero (half an ulp a wgmma, 1536 of them); a fresh
    accumulator every 32 k' keeps the error a small share of the tolerance
    (chip_levers.py --acc measured the same on the card: ~1.0-1.4
    tolerances whole, ~0.02 folded)."""
    rng = np.random.default_rng(5)
    m, k, n = 48, 4096, 64
    x = (rng.standard_normal((m, k)) * 1.37).astype(F32)
    w = (rng.standard_normal((k, n)) * 0.02).astype(F32)
    ref = x.astype(np.float64) @ w.astype(np.float64)
    folded = _within(product_3xtf32(x, w), ref)
    whole = _within(product_3xtf32(x, w, fold=False), ref)
    assert folded <= 0.1
    assert whole > 5 * folded


# ---------------------------------------------------------------------------
# the source and the launch
# ---------------------------------------------------------------------------


def _strip_comments(src: str) -> str:
    return re.sub(r"//[^\n]*", "", src)


def test_source_binds_the_3xtf32_body():
    srcs = {p.name: _strip_comments(p.read_text()) for p in CSRC.iterdir()
            if p.suffix in (".cu", ".cuh")}
    assert not any("gemm_f32_kernel" in s for s in srcs.values())
    fp = srcs["qmm_fp.cuh"]
    body = fp[fp.index("cudaError_t run_gemm_f32("):]
    body = body[:body.index("\n}\n")]
    assert "tc::gemm_tf32x3_kernel<FMT>" in body
    kern = fp[fp.index("gemm_tf32x3_kernel(const"):]
    kern = kern[:kern.index("\n}\n")]
    # the small terms first, a fresh accumulator at each step's first k8
    small = kern.index("wgmma_tf32_rs(acc, xl[p], bh + 2 * kk, kk == 0 ? 0 : 1)")
    assert small < kern.index("wgmma_tf32_rs(acc, xh[p], bl + 2 * kk, 1)") < kern.index(
        "wgmma_tf32_rs(acc, xh[p], bh + 2 * kk, 1)")
    assert "tot[i] += acc[i]" in kern and "store_tile<BN>(tot," in kern
    assert "atom" not in kern   # each output written once: no atomics
    assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in fp
    # the rounding the tests emulate (cvt.rna.tf32.f32's, in integer steps)
    assert "(__float_as_uint(v) + 0x1000u) & 0xFFFFE000u" in fp
    for name, entry in (("qmatmul_lut.cu", "nst_qmatmul_lut_gemm_f32"),
                        ("qmatmul_planar.cuh", "nst_qmatmul_planar_gemm_f32")):
        s = srcs[name]
        e = s[s.index(entry):]
        e = e[:e.index("\n}\n")]
        assert "run_gemm_f32<" in e


@pytest.mark.parametrize("route", ["F", "P", "I"])
@pytest.mark.parametrize("m", [33, 1500])
def test_fp_launch_hands_the_gemm_entry_its_arguments(route, m, monkeypatch):
    """`_fp_launch` with the C entry stubbed: float32 x at M > 32 calls the
    `_f32` GEMM entry once, with x in band-major order, and counts one launch
    under the route's `_f32` counter."""
    label = {"F": "nf4", "P": "int5-asym", "I": "gptq"}[route]
    pack = next(p for p in PACKS if p[0] == label)
    k, n = 1280, 128
    qt, _ = _draw(pack, k, n, seed=2, small=False)
    calls = []

    def fake_fn(lib, name, n_ptr, n_int, n_float=0):
        def f(*args):
            calls.append((lib, name, n_ptr, n_int, args))
            return 0
        return f

    monkeypatch.setattr(_build.kernels, "fn", fake_fn)
    monkeypatch.setattr(_build, "stream_handle", lambda: 0)
    seen = {}
    band_major = tmm._band_major

    def spy(x2, bands):
        seen["xk"] = band_major(x2, bands)
        return seen["xk"]

    monkeypatch.setattr(tmm, "_band_major", spy)
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(m))
    before = dict(_build.launches)
    if route == "F":
        planes, name, lib = list(qt.data), "qmatmul_lut", "qmatmul_lut"
        extra_ptrs, extra_ints, counter = [0], [], ""
    else:
        planes = list(qt.data) + [qt.data[0]] * (3 - len(qt.data))
        name, lib = "qmatmul_planar", f"qmatmul_planar_int{qt.spec.bits}"
        extra_ptrs, extra_ints = [0], [tmm._ZMODES["int"]]
        counter = "qmatmul_int" if route == "I" else ""
    out = tmm._fp_launch(name, lib, x, qt, planes, extra_ptrs, extra_ints,
                         counter=counter)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert len(calls) == 1
    lib_, entry, n_ptr, n_int, args = calls[0]
    assert (lib_, entry) == (lib, f"nst_{name}_gemm_f32")
    assert n_ptr == len(planes) + 3 + len(extra_ptrs)  # x, planes, scales, extra, out
    assert n_int == 5 + len(extra_ints)
    assert args[0] == seen["xk"].data_ptr()
    bands = _bands(qt.spec)
    torch.testing.assert_close(seen["xk"], x.view(m, bands, k // bands)
                               .transpose(1, 2).reshape(m, k), rtol=0, atol=0)
    ints = args[n_ptr:n_ptr + n_int]
    g = qt.spec.effective_group(k)
    assert tuple(ints[:5]) == (m, k, n, g, int(qt.scales.dtype == torch.bfloat16))
    moved = {c: v - before.get(c, 0) for c, v in _build.launches.items()
             if v != before.get(c, 0)}
    want = {"F": "qmatmul_lut_f32", "P": "qmatmul_planar_f32",
            "I": "qmatmul_int_f32"}[route]
    assert moved == {want: 1}
