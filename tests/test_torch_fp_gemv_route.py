"""The host side of the GEMV of kernels F, P and P's one-plane INT instances
(`csrc/qmm_fp.cuh`, M <= 32), on the CPU: numpy emulations of the device
arithmetic (no kernel runs here).

* The decode: an integer code becomes a float by the exponent trick
  (`magic(c) = 2^23 + c` as a float's bits, less `zsub = magic(z)`: the zero
  term in the subtrahend), a byte by one prmt (`magic_byte`), fp8 codes by
  a paired conversion, a table entry (NF4 / FP4 / a converter's table) as a
  bf16 hi + lo pair.  Emulated bit for bit, the CUDA-core value (`s * t`,
  or `t * s + m` for float offsets) equals `dequantize(qt, torch.float32)`
  for every code, zero mode and scale dtype of INT1-INT8, fp8 e4m3 / e5m2
  and the tables; every tensor-core B operand is exact in TF32 (integer
  terms, fp8 values, the table's hi and lo) and hi + lo is within 2^-16 of
  each table entry (2^-17 by construction).
* The tensor-core body (`gemv_mma_kernel`, 9..32 rows with bf16 x):
  its cp.async staging of x, the lanes' word loads and the m16n8k8
  fragments as PTX defines them, emulated lane by lane over the planar
  pack, write every output (row, column) once, read every word of every
  plane once, and give x @ W exactly on integer data, at M = 9, 16, 31,
  32, several cluster sizes, and g = 8, 16 and 128 (and a K whose band
  rows a group does not divide).
* The CUDA-core bodies (`gemv_kernel`, `gemv1_kernel`: 1..8 rows, and every
  M with float32 x in blocks of 8 rows): the split / chunk walk writes
  every output once and reads every word once; `gemv1_kernel`'s per-band
  scale and zero term, held in registers and reloaded when `next_any`
  says a band entered a new group, are the group's of every chunk's rows.
* Both walks' products, in float32 on real data, equal the JAX package's
  `qmatmul_xla` (float32 at M <= 32) within F32_TOL of the largest output.
* One launch: `fp_gemv_launches` (and `_fp_launch`, with the entry
  stubbed) make one GEMV launch at every M <= 32, plus at most one reduce
  (the CUDA-core splits); the entries bind `run_gemv`, which has no loop
  over rows.
"""

import dataclasses
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.ops import matmul as jm
from neural_speed_tpu.ops.qtypes import named_qspec as jax_named_qspec
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch.ops import matmul as tmm
from neural_speed_tpu_torch.ops.qtypes import (FP4_LUT, NF4_LUT, QSpec, QType,
                                               named_qspec, plane_widths)
from neural_speed_tpu_torch.ops.quantize import (QTensor, dequantize, lut_values,
                                                 pack_codes)

from tests.torch_port_util import port_qtensor

jq = importlib.import_module("neural_speed_tpu.ops.quantize")

CSRC = Path(tmm.__file__).resolve().parent.parent / "csrc"
F32 = np.float32
# Both walks against qmatmul_xla: float32 sums in another order, and the
# table's hi + lo (2^-17 of an entry) -> 2^-16 of max|out|.
F32_TOL = 2.0 ** -16


# ---------------------------------------------------------------------------
# the device's operations
# ---------------------------------------------------------------------------


def magic(c) -> np.ndarray:
    return (np.uint32(0x4B000000) | np.asarray(c, np.uint32)).view(F32)


def byte_perm(x, y, sel: int) -> np.ndarray:
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the 8-byte value y:x."""
    x = np.asarray(x, np.uint32)
    xy = (np.uint64(y) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(x.shape, np.uint64)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        out |= ((xy >> np.uint64(8 * src)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def magic_byte(w, j: int) -> np.ndarray:
    return byte_perm(w, 0x4B00, 0x5440 | j).view(F32)


def int_term(code, zsub, bits: int) -> np.ndarray:
    """`int_term<FMT>`: magic(code) - zsub, or 2 * code - 1 for INT1."""
    code = np.asarray(code, np.uint32)
    if bits == 1:
        return (magic(code << np.uint32(1)) - F32(8388609.0)).astype(F32)
    return (magic(code) - np.asarray(zsub, F32)).astype(F32)


def int1_value(code, s) -> np.ndarray:
    """The CUDA-core bodies' INT1 weight s * (2c - 1): s with its sign bit
    flipped where the code is 0."""
    flip = ((~np.asarray(code, np.uint32)) & np.uint32(1)) << np.uint32(31)
    return (np.asarray(s, F32).view(np.uint32) ^ flip).view(F32)


def dq_value(t, s, z, zf: bool) -> np.ndarray:
    t, s, z = (np.asarray(v, F32) for v in (t, s, z))
    return (t * s + z).astype(F32) if zf else (s * t).astype(F32)


def tf32_trunc(v) -> np.ndarray:
    """What the tensor cores read of a TF32 operand: the low 13 mantissa
    bits dropped."""
    return (np.asarray(v, F32).view(np.uint32) & np.uint32(0xFFFFE000)).view(F32)


def bf16_hi_lo(t) -> tuple:
    """A table entry as the tensor-core body takes it: hi = bf16(t), lo =
    bf16(t - hi), each exact as a TF32 operand."""
    t = torch.from_numpy(np.asarray(t, F32))
    hi = t.to(torch.bfloat16).float()
    lo = (t - hi).to(torch.bfloat16).float()
    return hi.numpy(), lo.numpy()


def fp8_value(codes: np.ndarray, qtype) -> np.ndarray:
    """The paired conversion's result (fp8 -> half, exact, -> float)."""
    dt = torch.float8_e4m3fn if qtype == QType.FP8_E4M3 else torch.float8_e5m2
    return torch.from_numpy(codes.astype(np.uint8)).view(dt).float().numpy()


# ---------------------------------------------------------------------------
# packs
# ---------------------------------------------------------------------------

# (label, format, group, symmetric, scale dtype, zeros: None / "uint8" /
# "float32")
PACKS = [
    ("nf4", "nf4", 128, True, "bfloat16", None),
    ("fp4-f32s", "fp4", 16, True, "float32", None),
    ("int1", "int1", 128, True, "bfloat16", None),
    ("int2-asym", "int2", 128, False, "float32", "uint8"),
    ("q2_k", "int2", 16, False, "float32", "float32"),
    ("int3", "int3", 8, True, "bfloat16", None),
    ("gptq", "int4", 128, False, "float32", "uint8"),
    ("q4_0", "int4", 32, True, "float32", None),
    ("q4_1-g8", "int4", 8, False, "float32", "float32"),
    ("int5-asym", "int5", 128, False, "bfloat16", "uint8"),
    ("int5-off", "int5", 16, False, "float32", "float32"),
    ("int6", "int6", 16, True, "float32", None),
    ("int7", "int7", 128, True, "bfloat16", None),
    ("q8_0", "int8", 32, True, "float32", None),
    ("int8-asym", "int8", 8, False, "float32", "uint8"),
    ("int8-off", "int8", 16, False, "float32", "float32"),
    ("e4m3", "fp8_e4m3", 128, True, "bfloat16", None),
    ("e5m2", "fp8_e5m2", 16, True, "float32", None),
]


def _spec(fmt, g, sym, sdt) -> QSpec:
    return named_qspec(fmt, g, sym, sdt)


def _bands(spec: QSpec) -> int:
    return tmm._finest_bands(spec)


def _draw(pack, k: int, n: int, seed: int, small: bool):
    """A pack drawn with numpy: codes (uniform, fp8 from a cast normal),
    scales and zeros.  `small`: small integer scales and offsets, so that
    a product over integer x is exact in float64."""
    _, fmt, g, sym, sdt, zeros = pack
    spec = _spec(fmt, g, sym, sdt)
    rng = np.random.default_rng(seed)
    if spec.is_fp8:
        v = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
        dt = torch.float8_e4m3fn if spec.qtype == QType.FP8_E4M3 else torch.float8_e5m2
        codes = v.to(dt).view(torch.uint8).numpy()
        data = (torch.from_numpy(codes),)
    else:
        bits = 4 if spec.is_lut else spec.bits
        codes = rng.integers(0, 2 ** bits, (k, n))
        data = pack_codes(torch.from_numpy(codes), bits)
    gs = k // g
    if small:
        s = rng.integers(1, 4, (gs, n)).astype(np.float32)
    else:
        s = (rng.uniform(0.5, 1.5, (gs, n)) * 0.02).astype(np.float32)
    scales = torch.from_numpy(s)
    if sdt == "bfloat16":
        scales = scales.to(torch.bfloat16)
    z = None
    if zeros == "uint8":
        z = torch.from_numpy(rng.integers(0, 2 ** spec.bits, (gs, n)).astype(np.uint8))
    elif zeros == "float32":
        m = (rng.integers(-2, 3, (gs, n)) if small
             else rng.uniform(-0.1, 0.1, (gs, n))).astype(np.float32)
        z = torch.from_numpy(m)
    return QTensor(data, scales, z, None, spec, (k, n)), codes


def _zmode(qt: QTensor) -> str:
    if qt.zeros is None:
        return "none" if qt.spec.is_fp8 or qt.spec.is_lut else "sym"
    return "float" if qt.zeros.is_floating_point() else "int"


def _terms(qt: QTensor):
    """Per (group, column): the scale and the zero term as the kernels load
    them (`scales4` / `zero_terms4`): zsub = magic(z), or the offset m."""
    s = qt.scales.float().numpy()
    mode = _zmode(qt)
    if mode == "float":
        z = qt.zeros.numpy().astype(F32)
    elif mode == "int":
        z = magic(qt.zeros.numpy())
    elif mode == "sym":
        z = np.full(s.shape, magic(1 << (qt.spec.bits - 1)), F32)
    else:
        z = np.full(s.shape, magic(0), F32)
    return s, z, mode


def _words(qt: QTensor):
    """The planes as the kernels read them: uint32 words, or the byte rows
    as uint32 words of 4 columns."""
    if tmm._byte_rows(qt.spec):
        b = qt.data[0].numpy()
        return [b.reshape(b.shape[0], -1, 4).copy().view(np.uint32)[..., 0]]
    return [p.numpy().view(np.uint32) for p in qt.data]


def code_of(spec: QSpec, slots, b: int) -> np.ndarray:
    """`code_of<FMT>`: band b's code from one word row's slots (plane p's
    q words at slot0(p) .. slot0(p) + q - 1)."""
    widths = (4,) if spec.is_lut else plane_widths(spec.bits)
    ef = _bands(spec)
    code, slot0, shift = 0, 0, sum(widths)
    for w in widths:
        q = ef * w // 32
        shift -= w
        word = slots[slot0 + b % q]
        code = code | (((word >> np.uint32(w * (b // q))) & np.uint32((1 << w) - 1))
                       << np.uint32(shift))
        slot0 += q
    return np.asarray(code, np.uint32)


def _slots(spec: QSpec):
    """(plane, jq) of each slot, in slot order."""
    widths = (4,) if spec.is_lut else plane_widths(spec.bits)
    ef = _bands(spec)
    return [(p, jq) for p, w in enumerate(widths) for jq in range(ef * w // 32)]


def _table(qt: QTensor) -> np.ndarray:
    return lut_values(qt.spec, torch.float32, "cpu").numpy()


def _b_terms(qt, words_of_slots, codes_bytes_col, b, zsub, zf, tab_hl):
    """The B term (float32) of band b of a lane's words: the integer term,
    the fp8 value, or the table's (hi, lo)."""
    spec = qt.spec
    if spec.is_fp8:
        return fp8_value(codes_bytes_col, spec.qtype), None
    if tmm._byte_rows(spec):
        return (magic(codes_bytes_col) - np.asarray(zsub, F32)).astype(F32), None
    code = code_of(spec, words_of_slots, b)
    if spec.is_lut:
        return tab_hl[0][code], tab_hl[1][code]
    bits = spec.bits
    zs = np.full(np.shape(zsub), magic(0), F32) if zf else zsub
    return int_term(code, zs, bits), None


# ---------------------------------------------------------------------------
# the decode
# ---------------------------------------------------------------------------


def test_integer_term_is_exact_for_every_code_and_zero_point():
    c, z = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    t = int_term(c, magic(z), 8)
    np.testing.assert_array_equal(t, (c - z).astype(F32))
    # a TF32 operand as it is: no bit below TF32's mantissa
    assert (t.view(np.uint32) & np.uint32(0x1FFF) == 0).all()
    np.testing.assert_array_equal(int_term(np.arange(2), 0, 1), [-1.0, 1.0])
    # magic_byte: byte j of a word by one prmt
    w = np.random.default_rng(0).integers(0, 2 ** 32, 4096).astype(np.uint32)
    for j in range(4):
        np.testing.assert_array_equal(
            magic_byte(w, j) - F32(8388608.0), ((w >> np.uint32(8 * j)) & 255).astype(F32))


@pytest.mark.parametrize("sdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("zeros", [None, "uint8", "float32"])
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7, 8])
def test_int_decode_is_dequantize(bits, zeros, sdt):
    """Every code of an INT pack, each zero mode and scale dtype, decoded
    as the CUDA-core bodies decode it, equals `dequantize` bit for bit."""
    k, n, g = 32 * 2 ** min(bits, 4), 48, 8
    pack = ("p", f"int{bits}", g, zeros is None, sdt, zeros)
    qt, codes = _draw(pack, k, n, seed=bits, small=False)
    codes = np.asarray(codes, np.uint32)
    s, z, mode = _terms(qt)
    zf = bits != 1 and mode == "float"
    rep = lambda a: np.repeat(a, g, axis=0)
    zsub = np.full(codes.shape, magic(0), F32) if zf else rep(z)
    got = dq_value(int_term(codes, zsub, bits), rep(s), rep(z), zf)
    want = dequantize(qt, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    if bits == 1:  # the CUDA-core bodies' sign flip
        np.testing.assert_array_equal(int1_value(codes, rep(s)), want)
    # bytes: the prmt path
    if bits == 8:
        w = _words(qt)[0]
        for j in range(4):
            t = magic_byte(w, j) - zsub[:, j::4]
            np.testing.assert_array_equal(
                dq_value(t, rep(s)[:, j::4], rep(z)[:, j::4], zf), want[:, j::4])


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2"])
def test_fp8_pairs_are_exact(fmt):
    spec = named_qspec(fmt, 32)
    codes = np.arange(256, dtype=np.uint8)
    v = fp8_value(codes, spec.qtype)
    ok = np.isfinite(v)
    assert ok.sum() >= 240
    # exact TF32 operands: the tensor-core body takes them as they are
    assert (v[ok].view(np.uint32) & np.uint32(0x1FFF) == 0).all()
    pack = ("p", fmt, 32, True, "float32", None)
    qt, c = _draw(pack, 64, 32, seed=3, small=False)
    s = np.repeat(qt.scales.numpy(), 32, axis=0)
    np.testing.assert_array_equal((fp8_value(c, spec.qtype) * s).astype(F32),
                                  dequantize(qt, torch.float32).numpy())


@pytest.mark.parametrize("table", ["nf4", "fp4", "custom"])
def test_table_hi_lo_split(table):
    """A table entry as the tensor-core body takes it: a bf16 hi and a bf16
    lo (one 4-byte word of the shared table), both exact TF32 operands,
    within 2^-16 of the entry (2^-17 by construction)."""
    if table == "custom":
        t = np.random.default_rng(1).standard_normal(16).astype(F32)
    else:
        t = np.asarray(NF4_LUT if table == "nf4" else FP4_LUT, F32)
    hi, lo = bf16_hi_lo(t)
    np.testing.assert_array_equal(tf32_trunc(hi), hi)
    np.testing.assert_array_equal(tf32_trunc(lo), lo)
    err = np.abs(t.astype(np.float64) - hi - lo)
    assert (err <= 2.0 ** -16 * np.abs(t)).all()
    assert (err <= 2.0 ** -17 * np.abs(t)).all()


# ---------------------------------------------------------------------------
# the tensor-core body
# ---------------------------------------------------------------------------

MMA_BN = tmm.FP_GEMV_MMA_COLS


def mma_walk(x: np.ndarray, qt: QTensor, splits: int, exact: bool):
    """`gemv_mma_kernel` lane by lane over x [M, K] (bf16 values) and the
    pack, every warp of every column block at once: returns the output, how
    often each (row, column) partial was written, and how often each word
    of each plane was read.  `exact`: float64 arithmetic (integer data);
    else float32 as the card rounds (each MMA's float32 result, then one
    fmaf into the accumulator)."""
    spec = qt.spec
    m, k = x.shape
    n = qt.shape[1]
    g = spec.effective_group(k)
    ef = _bands(spec)
    kw = k // ef
    sr = tmm.fp_gemv_mma_step(ef)
    mt16 = 2 if m > 16 else 1
    mp = 16 * mt16
    byte = tmm._byte_rows(spec)
    planes = _words(qt)
    slots = [(0, 0)] if byte else _slots(spec)
    reads = [np.zeros(p.shape, np.int64) for p in planes]
    s_all, z_all, mode = _terms(qt)
    zf = mode == "float" and spec.bits != 1 and not spec.is_lut
    tab_hl = None
    if spec.is_lut:
        tab_hl = bf16_hi_lo(_table(qt))
    dt = np.float64 if exact else F32
    rs = ((kw + splits - 1) // splits + 7) // 8 * 8
    nw = -(-n // MMA_BN) * (MMA_BN // 32)               # warps over the blocks
    lane = np.arange(32)
    gq, t = lane // 4, lane % 4
    c0 = 32 * np.arange(nw)[:, None]                     # [W, 1]
    n4, n8 = c0 + 4 * gq, c0 + 8 * t                     # [W, 32]
    live4 = n4 < n
    n4c = np.minimum(n4, n - 4)
    e = np.arange(4)
    c_row = gq[:, None] + 8 * (e >> 1)                   # [32, 4] C row of (lane, e)
    c_col = 2 * t[:, None] + (e & 1)                     # [32, 4] C column
    part = np.zeros((splits, mp, nw * 32), dt)
    written = np.zeros(part.shape, np.int64)
    for split in range(splits):
        rlo = min(split * rs, kw)
        rhi = min(rlo + rs, kw)
        acc = np.zeros((mt16, nw, 4, 32, 4), dt)        # [i][warp][jn][lane][e]
        for r0 in range(rlo, rhi, sr):
            xs = np.zeros((mp, ef, sr), dt)              # the cp.async stage
            # the factor rows: band b's i-th group of the step at b * sub + i
            sub = sr // 8
            cols = np.arange(nw * 32)
            fs = np.zeros((sub * ef, nw * 32), F32)
            fz = np.zeros(fs.shape, F32)
            rend = min(r0 + sr, rhi)
            for q in range(sub):
                if r0 + 8 * q < rhi:
                    for b in range(ef):
                        xs[:m, b, 8 * q:8 * q + 8] = x[:, b * kw + r0 + 8 * q:b * kw + r0 + 8 * q + 8]
            for b in range(ef):
                g0, g1 = (b * kw + r0) // g, (b * kw + rend - 1) // g
                assert g1 - g0 < sub
                for i, G in enumerate(range(g0, g1 + 1)):
                    fs[b * sub + i] = np.where(cols < n, s_all[G][np.minimum(cols, n - 1)], 0)
                    fz[b * sub + i] = np.where(cols < n, z_all[G][np.minimum(cols, n - 1)], 0)
            steps_j = [j for j in range(sr // 8) if r0 + 8 * j < rhi]
            wls = {}
            for j in steps_j:
                r = r0 + 8 * j
                # the lanes' words: word rows r + 2t + u, columns n4 + jn
                wl = np.zeros((2, len(slots), 4, nw, 32), np.uint32)
                for u in range(2):
                    rows = np.broadcast_to(r + 2 * t + u, n4.shape)
                    for si, (p, jq) in enumerate(slots):
                        if byte:
                            v = planes[0][rows, n4c // 4]
                            np.add.at(reads[0], (rows[live4], n4[live4] // 4), 1)
                            for jn in range(4):
                                wl[u, si, jn] = np.where(live4, v, 0)
                        else:
                            for jn in range(4):
                                wl[u, si, jn] = np.where(live4, planes[p][jq * kw + rows, n4c + jn], 0)
                                np.add.at(reads[p], (jq * kw + rows[live4], (n4 + jn)[live4]), 1)
                wls[j] = wl
            for b in range(ef):
                # each k-step's product times its group's scale (and offset)
                d = np.zeros((mt16, nw, 4, 16, 8), dt)
                ds = np.zeros((mt16, 16, 8), dt)
                grow = -1

                def flush():
                    s8 = fs[grow][n8[..., None] + np.arange(8)]            # [W, 32, 8]
                    sc = np.stack([s8[..., 4 * (e & 1) + jn] for jn in range(4)], 1)
                    m8 = fz[grow][n8[..., None] + np.arange(8)]
                    mm = np.stack([m8[..., 4 * (e & 1) + jn] for jn in range(4)], 1)
                    for i in range(mt16):
                        dl = d[i][:, :, c_row, c_col]                      # [W, jn, 32, 4]
                        acc[i] = (acc[i] + sc.astype(np.float64) * dl).astype(dt)
                        if zf:
                            acc[i] = (acc[i] + mm * ds[i][c_row, 2 * t[:, None]]).astype(dt)

                for j in steps_j:
                    r = r0 + 8 * j
                    wl = wls[j]
                    row = b * sub + ((b * kw + r0) % g + 8 * j) // g    # the stage's factor row
                    assert (b * kw + r0) // g + row - b * sub == (b * kw + r) // g
                    if grow >= 0:
                        flush()
                    grow = row
                    d[:] = 0
                    ds[:] = 0
                    zs = fz[row][n4[..., None] + np.arange(4)]            # [W, 32, 4]
                    bt = np.zeros((2, 4, nw, 32), F32)
                    bl = np.zeros((2, 4, nw, 32), F32)
                    for u in range(2):
                        for jn in range(4):
                            if byte:
                                cb = (wl[u, 0, 0] >> np.uint32(8 * jn)) & np.uint32(255)
                                if spec.is_fp8:
                                    bt[u, jn] = fp8_value(cb, spec.qtype)
                                else:
                                    zsub = magic(0) if zf else zs[..., jn]
                                    bt[u, jn] = magic(cb) - zsub
                                continue
                            code = code_of(spec, [wl[u, si, jn] for si in range(len(slots))], b)
                            if spec.is_lut:
                                bt[u, jn], bl[u, jn] = tab_hl[0][code], tab_hl[1][code]
                            else:
                                zsub = np.full(code.shape, magic(0), F32) if zf else zs[..., jn]
                                bt[u, jn] = int_term(code, zsub, spec.bits)
                    # B [W, jn, k, n]: k = t (u = 0) / t + 4 (u = 1), n = gq
                    bm = np.zeros((nw, 4, 8, 8))
                    bml = np.zeros((nw, 4, 8, 8))
                    for u in range(2):
                        bm[:, :, t + 4 * u, gq] = bt[u].transpose(1, 0, 2)
                        bml[:, :, t + 4 * u, gq] = bl[u].transpose(1, 0, 2)
                    for i in range(mt16):
                        a = np.zeros((16, 8))                # A: rows gq / gq + 8, k t / t + 4
                        for h in range(2):
                            for u in range(2):
                                a[gq + 8 * h, t + 4 * u] = xs[16 * i + gq + 8 * h, b, 8 * j + 2 * t + u]
                        # each MMA adds its exact products to the accumulator
                        d[i] = (d[i] + np.einsum("rk,wjkn->wjrn", a, bm)).astype(dt)
                        if spec.is_lut:
                            d[i] = (d[i] + np.einsum("rk,wjkn->wjrn", a, bml)).astype(dt)
                        if zf:
                            ds[i] = (ds[i] + a.astype(np.float64) @ np.ones((8, 8))).astype(dt)
                if grow >= 0:
                    flush()
        for i in range(mt16):
            for jn in range(4):
                for ee in range(4):
                    row = 16 * i + c_row[:, ee]                           # [32]
                    col = 32 * np.arange(nw)[:, None] + 8 * t + 4 * (ee & 1) + jn   # [W, 32]
                    part[split, np.broadcast_to(row, col.shape), col] = acc[i, :, jn, :, ee]
                    np.add.at(written[split], (np.broadcast_to(row, col.shape), col), 1)
    out = np.zeros((m, n), dt)
    for split in range(splits):          # rank order
        out = (out + part[split, :m, :n]).astype(dt)
    return out, written[:, :m, :n], reads


def _reads_once(reads) -> bool:
    return all((r == 1).all() for r in reads)


def _exact_product(x, qt):
    """x @ W in float64 (small integer codes, scales and zeros: exact)."""
    return x.astype(np.float64) @ dequantize(qt, torch.float64).numpy()


MMA_PACKS = [p for p in PACKS if p[0] in (
    "nf4", "int1", "int2-asym", "q2_k", "int3", "gptq", "q4_1-g8", "int5-asym",
    "int6", "int7", "q8_0", "int8-off", "e4m3")]


def _k_for(pack, base: int = 512) -> int:
    """The least K >= base that the kernels take for the pack: a multiple of
    the group and of 8 word rows of every band (`_fp_shape_ok`)."""
    import math

    period = math.lcm(pack[2], 8 * _bands(_spec(*pack[1:5])))
    return -(-base // period) * period


@pytest.mark.parametrize("m", [9, 16, 31, 32])
@pytest.mark.parametrize("pack", MMA_PACKS, ids=[p[0] for p in MMA_PACKS])
def test_mma_walk_covers_every_output_once_and_reads_each_word_once(pack, m):
    k, n = _k_for(pack), 264
    qt, codes = _draw(pack, k, n, seed=m, small=True)
    splits = 2 if m % 2 else 4
    x = np.random.default_rng(m).integers(-3, 4, (m, k)).astype(np.float64)
    got, written, reads = mma_walk(x, qt, splits, exact=True)
    assert (written == 1).all()
    assert _reads_once(reads)
    if not qt.spec.is_lut:
        np.testing.assert_array_equal(got, _exact_product(x, qt))
    else:   # the table's hi + lo: within 2^-17 of each entry
        want = _exact_product(x, qt)
        assert np.abs(got - want).max() <= 2.0 ** -16 * np.abs(want).max()


@pytest.mark.parametrize("splits", [1, 2, 8])
def test_mma_walk_where_groups_do_not_divide_the_band_rows(splits):
    """K = 1536 at 32 bands: 48 word rows a band, g = 32 does not divide
    them, so groups straddle bands (`group_of`'s slow path)."""
    pack = ("int5-g32", "int5", 32, False, "float32", "uint8")
    qt, codes = _draw(pack, 1536, 136, seed=splits, small=True)
    assert (1536 // 32) % 32 != 0
    x = np.random.default_rng(7).integers(-3, 4, (13, 1536)).astype(np.float64)
    got, written, reads = mma_walk(x, qt, splits, exact=True)
    assert (written == 1).all() and _reads_once(reads)
    np.testing.assert_array_equal(got, _exact_product(x, qt))


# ---------------------------------------------------------------------------
# the CUDA-core bodies
# ---------------------------------------------------------------------------


def simt_walk(x: np.ndarray, qt: QTensor, splits: int, exact: bool):
    """`gemv_kernel` (one plane, bytes) / `gemv1_kernel` (multi-plane) over
    x [M, K]: block rows of MT rows (gridDim.z), K splits of whole 8-row
    chunks, each chunk's words read once; gemv1's per-band scale and zero
    term held across chunks and reloaded per `next_any` (checked against
    the group of each chunk).  Returns the output (the reduce's split
    order), the writes per (row, column) and the reads per word."""
    spec = qt.spec
    m, k = x.shape
    n = qt.shape[1]
    g = spec.effective_group(k)
    ef = _bands(spec)
    kw = k // ef
    multi = len(tmm.planes_of(spec)) > 1
    byte = tmm._byte_rows(spec)
    mt = 8 if m > 4 else 4 if m > 1 else 1
    if multi:
        r1 = 4 if len(_slots(spec)) > 5 or mt > 1 else 8
    else:
        r1 = 4 if mt == 8 else 8
    planes = _words(qt)
    slots = _slots(spec) if not byte else [(0, 0)]
    reads = [np.zeros(p.shape, np.int64) for p in planes]
    s_all, z_all, mode = _terms(qt)
    zf = mode == "float" and spec.bits != 1 and not spec.is_lut
    tab = _table(qt) if spec.is_lut else None
    dt = np.float64 if exact else F32
    rows_ps = ((kw + splits - 1) // splits + 7) // 8 * 8
    part = np.zeros((splits, m, n), dt)
    written = np.zeros((splits, m, n), np.int64)
    cols = np.arange(n)
    for z0 in range(0, m, mt):
        rows_m = np.arange(z0, min(z0 + mt, m))
        for split in range(splits):
            kb0 = split * rows_ps
            nrows = max(0, min(kb0 + rows_ps, kw) - kb0)
            acc = np.zeros((len(rows_m), n), dt)
            sc = np.zeros((ef, n), F32)
            zt = np.zeros((ef, n), F32)
            next_any = 0
            for c in range(0, nrows, r1):
                kb = kb0 + c
                if multi and (c == 0 or kb >= next_any):     # reload
                    nxt = 1 << 30
                    for b in range(ef):
                        G = (b * kw + kb) // g
                        start = G * g - b * kw
                        if c == 0 or start == kb:
                            sc[b], zt[b] = s_all[G], z_all[G]
                        nxt = min(nxt, start + g)
                    next_any = nxt
                for b in range(ef):
                    G = (b * kw + kb) // g
                    if multi:   # the held terms are the chunk's group's
                        np.testing.assert_array_equal(sc[b], s_all[G])
                        np.testing.assert_array_equal(zt[b], z_all[G])
                    s_b, z_b = s_all[G], z_all[G]
                    for i in range(r1):
                        r = kb + i
                        if byte:
                            if b == 0:
                                reads[0][r] += 1
                            cb = (planes[0][r, cols // 4] >> np.uint32(8 * (cols % 4))) & np.uint32(255)
                            if spec.is_fp8:
                                wv = (fp8_value(cb, spec.qtype) * s_b).astype(F32)
                            else:
                                t = magic(cb) - (magic(0) if zf else z_b)
                                wv = dq_value(t, s_b, z_b, zf)
                        else:
                            sl = []
                            for p, jq in slots:
                                if b == 0:
                                    reads[p][jq * kw + r] += 1
                                sl.append(planes[p][jq * kw + r])
                            code = code_of(spec, sl, b)
                            if spec.is_lut:
                                wv = (tab[code] * s_b).astype(F32)
                            elif spec.bits == 1:
                                wv = int1_value(code, s_b)
                            else:
                                zs = np.full(n, magic(0), F32) if zf else z_b
                                wv = dq_value(int_term(code, zs, spec.bits), s_b, z_b, zf)
                        xv = x[rows_m, b * kw + r]
                        acc = (acc + xv[:, None].astype(dt) * wv[None, :].astype(dt)).astype(dt)
            part[split, rows_m] = acc
            written[split, rows_m] += 1
    out = np.zeros((m, n), dt)
    for split in range(splits):
        out = (out + part[split]).astype(dt)
    return out, written, reads


SIMT_PACKS = [p for p in PACKS if p[0] in (
    "nf4", "fp4-f32s", "int1", "q2_k", "int3", "gptq", "int5-asym", "int5-off",
    "int6", "int7", "q8_0", "int8-asym", "e5m2")]


@pytest.mark.parametrize("m", [1, 4, 5, 8, 32])
@pytest.mark.parametrize("pack", SIMT_PACKS, ids=[p[0] for p in SIMT_PACKS])
def test_simt_walk_covers_every_output_once_and_reads_each_word_once(pack, m):
    """Rows 1..8 (bf16 x) and 32 (float32 x: four blocks of 8 rows)."""
    k, n = _k_for(pack, 512), 40
    qt, codes = _draw(pack, k, n, seed=m + 1, small=True)
    x = np.random.default_rng(m).integers(-3, 4, (m, k)).astype(np.float64)
    got, written, reads = simt_walk(x, qt, 3, exact=True)
    assert (written == 1).all()
    # once per block row: bf16 x up to 8 rows is one block row; float32 x
    # at 32 rows takes four
    assert all((r == -(-m // 8)).all() for r in reads)
    want = _exact_product(x, qt)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("g", [8, 16, 32, 128])
def test_gemv1_reload_holds_each_groups_terms(g):
    """`gemv1_kernel`'s held terms over K = 12288 (Llama's down repadded:
    384 rows a band, which g = 32 and 128 divide) and K = 1536 (48 rows a
    band: g = 32 does not divide them), int7 (4-row chunks) and int3
    (8-row chunks), at the splits the wrapper picks: simt_walk asserts the
    terms of every band at every chunk."""
    for fmt, k in (("int7", 12288), ("int3", 1536)):
        if k % g:
            continue
        pack = ("p", fmt, g, True, "float32", None)
        qt, _ = _draw(pack, k, 8, seed=g, small=True)
        splits = tmm._gemv_splits(k, 8, 132, 32, 128)
        x = np.ones((1, k))
        simt_walk(x, qt, splits, exact=True)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

XLA_PACKS = [p for p in PACKS if p[0] in (
    "nf4", "fp4-f32s", "int1", "q2_k", "int3", "gptq", "q4_0", "int5-asym",
    "int5-off", "int6", "int7", "q8_0", "int8-asym", "e4m3")]


def _jax_and_port(pack, k: int, n: int, seed: int):
    """The pack drawn by the JAX package's quantizer from a normal weight,
    and the same pack carried across to the port (float offsets, where the
    pack has them, drawn on both)."""
    _, fmt, g, sym, sdt, zeros = pack
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    jqt = jq.quantize(jnp.asarray(w), jax_named_qspec(fmt, g, sym, scale_dtype=sdt))
    if zeros == "float32":          # ggml convention: w = scale * code + m
        offs = rng.uniform(-0.1, 0.1, jqt.scales.shape).astype(np.float32)
        jqt = dataclasses.replace(jqt, zeros=jnp.asarray(offs))
    return jqt, port_qtensor(jqt)


@pytest.mark.parametrize("m", [1, 4, 9, 32])
@pytest.mark.parametrize("pack", XLA_PACKS, ids=[p[0] for p in XLA_PACKS])
def test_walk_product_matches_qmatmul_xla(pack, m):
    """The walk of the body that takes M rows of bf16 x (CUDA cores to 8,
    tensor cores above), in float32, against the JAX package's
    `qmatmul_xla` on float32 x of the same (bf16) values: float32 at
    M <= 32."""
    k, n = _k_for(pack, 1024), 136
    jqt, qt = _jax_and_port(pack, k, n, seed=m + 11)
    rng = np.random.default_rng(m)
    xb = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    if tmm.fp_gemv_body(m, torch.bfloat16) == "mma":
        got, _, _ = mma_walk(xb, qt, 2, exact=False)
    else:
        got, _, _ = simt_walk(xb, qt, 3, exact=False)
    want = np.asarray(jm.qmatmul_xla(jnp.asarray(xb), jqt), np.float32)
    assert want.dtype == np.float32 and want.shape == (m, n)
    tol = F32_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# one launch per call
# ---------------------------------------------------------------------------

SHAPES = {"qkv": (4096, 12288), "o": (4096, 4096), "gateup": (4096, 22016),
          "down": (12288, 4096), "head": (4096, 32000), "ragged": (1024, 264)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_one_gemv_launch_at_every_m(shape, dtype):
    k, n = SHAPES[shape]
    for bands, multi, table in ((32, True, False), (16, False, False),
                                (8, False, True), (1, False, False)):
        for m in range(1, tmm.GEMV_MAX_M + 1):
            launches = tmm.fp_gemv_launches(m, k, n, bands, multi, dtype, 132, table)
            names = [name for name, _ in launches]
            assert sum("gemv" in x for x in names) == 1, (m, names)
            assert names[0].startswith("gemv")
            assert names[1:] in ([], ["splitk_reduce_kernel"]), names
            grid = launches[0][1]
            if names[0] == "gemv_mma_kernel":
                assert dtype == torch.bfloat16 and m > 8
                assert grid[0] * tmm.FP_GEMV_MMA_COLS >= n
                assert grid[1] in (1, 2, 4, 8) and len(launches) == 1
                step = tmm.fp_gemv_mma_step(bands)
                assert grid[1] == 1 or (k // bands) // grid[1] >= step
            else:
                assert grid[2] * (8 if m > 4 else 4 if m > 1 else 1) >= m


@pytest.mark.parametrize("m", [1, 4, 8, 9, 16, 32])
@pytest.mark.parametrize("label", ["nf4", "int5-asym", "gptq", "e4m3"])
def test_fp_launch_hands_the_entry_the_routes_splits(label, m, monkeypatch):
    """`_fp_launch` with the C entry stubbed: it calls the GEMV entry once
    with the splits `fp_gemv_launches` says (the cluster size of the
    tensor-core body, the CUDA-core body's K splits)."""
    pack = next(p for p in PACKS if p[0] == label)
    k, n = 4096, 12288
    spec = _spec(*pack[1:5])
    qt, _ = _draw(pack, k, 64, seed=1, small=True)
    qt = dataclasses.replace(qt, shape=(k, n))
    calls = []

    def fake_fn(lib, name, n_ptr, n_int, n_float=0):
        def f(*args):
            calls.append((name, args))
            return 0
        return f

    monkeypatch.setattr(_build.kernels, "fn", fake_fn)
    monkeypatch.setattr(_build, "stream_handle", lambda: 0)
    monkeypatch.setattr(tmm, "_sm_count", lambda i: 132)
    x = torch.zeros((m, k), dtype=torch.bfloat16)
    planes = list(qt.data) + [qt.data[0]] * (3 - len(qt.data))
    tmm._fp_launch("qmatmul_planar", "lib", x, qt, planes, [0], [1])
    assert len(calls) == 1 and calls[0][0] == "nst_qmatmul_planar_gemv"
    args = calls[0][1]
    ints = args[len(planes) + 5:]          # x, planes, scales, zeros, partial, out
    mm, kk, nn, g, splits = ints[:5]
    assert (mm, kk, nn) == (m, k, n)
    bands = _bands(spec)
    want = tmm.fp_gemv_launches(m, k, n, bands, len(tmm.planes_of(spec)) > 1,
                                torch.bfloat16, 132, spec.is_lut)
    assert splits == want[0][1][1]


def _strip_comments(src: str) -> str:
    return re.sub(r"//[^\n]*", "", src)


def test_entries_bind_the_one_launch_gemv():
    src = _strip_comments((CSRC / "qmm_fp.cuh").read_text())
    body = src[src.index("cudaError_t run_gemv("):]
    body = body[:body.index("\n}\n")]
    # no loop over rows: one launch (and one reduce)
    assert "for (" not in body and "m0" not in body
    assert "launch_gemv_mma_s<FMT, 2>" in body and "launch_gemv_mma_s<FMT, 1>" in body
    assert body.count("launch_reduce(") == 1
    assert "__global__ void __launch_bounds__(32 * MMA_WARPS, 1)\ngemv_mma_kernel" in src
    assert re.search(r"constexpr int MMA_BN = 32 \* MMA_WARPS;", src)
    assert f"constexpr int MMA_WARPS = {tmm.FP_GEMV_MMA_COLS // 32};" in src
    assert f"constexpr int MMA_MAX_SPLITS = {tmm.FP_GEMV_MAX_SPLITS};" in src
    assert f"constexpr int GEMV_SIMT_MAX_M = {tmm.GEMV_SIMT_MAX_M};" in src
    assert "SR = EF >= 16 ? 8 : 128 / EF;" in src
    # no integer-to-float conversion per weight in the GEMV section
    gemv = src[src.index("float magic(uint32_t c)"):src.index("namespace tc {")]
    assert "int_value<" not in gemv and not re.search(r"(?<!sizeof)\(float\)", gemv)
    for name in ("qmatmul_lut.cu", "qmatmul_planar.cuh"):
        entry = _strip_comments((CSRC / name).read_text())
        gv = [m.start() for m in re.finditer(r"int nst_\w+_gemv(_f32)?\(", entry)]
        assert len(gv) == 2, name              # the bf16 and the float32 entry
        for at in gv:
            body = entry[at:entry.index("\n}", at)]
            assert re.search(r"run_gemv<", body) and "run_gemm" not in body, name
    grouped = _strip_comments((CSRC / "qmatmul_grouped_fp.cuh").read_text())
    assert "run_gemv_grouped<" in grouped
